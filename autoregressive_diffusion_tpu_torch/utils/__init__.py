from .device import resolve_device
from .checkpoint import (BFloat16Leaf, latest_step, load_model, restore_train_state,
                         save_model, save_train_state, wait_for_pending_saves)
from .bridge import (build_precond, flax_variables, from_bundle, jax_variables, leaf_tensor,
                     load_flax_variables, load_jax_train_state, load_jax_variables,
                     load_train_state_tree, state_from_jax, to_flax_names,
                     to_jax_names, train_state_tree, vae_from_bundle)
