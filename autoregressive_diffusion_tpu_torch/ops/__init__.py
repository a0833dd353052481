from .numerics import (normalize, mp_silu, mp_sum, mp_cat, mp_fourier,
                       mp_weight, bmult, resample)
from .rope import rope_qk, rope_tables, apply_rope, rotate_half
from . import masks
