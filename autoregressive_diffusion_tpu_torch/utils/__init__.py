from .device import resolve_device
from .bridge import (load_jax_train_state, load_jax_variables, state_from_jax,
                     to_jax_names)
