"""Data pipeline of the gym path: clips from gymnasium or a synthetic
stand-in, the native resize, and replay buffers. The CS path's latent
shards (cs_data, mds) are not ported yet."""
from .gym_data import (GymDataGenerator, SyntheticVideoGenerator, batched,
                       resize_frame, resize_frames_batch)
from .native import pm1_to_u8, resize_area_batch, u8_to_pm1
from .replay import DeviceReplay, ReplayLoader
