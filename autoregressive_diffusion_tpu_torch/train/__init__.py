from .loss import EDM2LossConfig, edm2_loss, learning_rate_schedule, top_losses
from .loss_weight import (MultiNoiseState, fit_and_broadcast, fourier_basis,
                          fourier_eval, init_coefs)
from .ema import (ema_update, exp_to_std, init_ema, power_function_beta,
                  solve_posthoc_coefficients, std_to_exp, traditional_ema_beta)
from .optim import ClippedAdamW, forced_weight_norm, global_norm, make_optimizer
from .train_state import (TrainState, create_train_state, make_replay_train_step,
                          make_scanned_train_step, make_train_step, step_seed)
from .cli import build_trainer, run_steps, synthetic_batch
from .quantize import normalize_weights, quantize_variables, quantize_weight, quantized_config
