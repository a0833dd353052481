from .sampler import (edm_sampler, generate, karras_schedule, make_sampler_callback,
                      mse_probe, prefill_fresh)
