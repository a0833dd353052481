"""Data pipelines: the gym path's clips from gymnasium or a synthetic
stand-in, the native resize and replay buffers; the CS path's latent
shards (.npz and local MDS)."""
from .cs_data import (LocalLatentShards, batched_latents, merge_shard_index, streaming_dataset,
                      write_latent_shard)
from .gym_data import (GymDataGenerator, SyntheticVideoGenerator, batched,
                       resize_frame, resize_frames_batch)
from .mds import MDSLocalReader, MDSShardWriter
from .native import pm1_to_u8, resize_area_batch, u8_to_pm1
from .replay import DeviceReplay, ReplayLoader
