"""The frozen cost functions against counts worked out by hand at one small shape."""
import pytest

from perf_bench import costs


def test_conv_cost_by_hand():
    # b=1, 4 frames (T=2), 2x2 pixels, 1 -> 1 channel, with context:
    # 36 multiply-adds a frame a tap set; 2d on 4 frames + context (2 taps) on 2.
    (fo, fb), (bo, bb) = costs.conv_cost(1, 4, 2, 2, 1, 1, False, True, "bfloat16")
    assert fo == 2 * 36 * (4 + 4) == 576
    assert fb == 2 * (16 + 27 + 32) + 16 == 166
    # dx: 4 frames + the context taps that exist (1 + 0); dw: every product
    assert bo == 2 * 36 * (4 + 1) + 2 * 36 * 8 == 936
    assert bb == 2 * (32 + 54 + 48) + 32 == 300


def test_flash_cost_by_hand():
    # DART over T = 2 frames of 1 token: clean 0 -> {0}, clean 1 -> {0, 1},
    # noisy 0 -> {itself}, noisy 1 -> {clean 0, itself}: 6 pairs.
    assert int(costs.train_frame_mask(2).sum()) == 6
    (fo, fb), (bo, bb) = costs.flash_cost("dart", 1, 1, 2, 1, 2, "bfloat16")
    assert (fo, bo) == (4 * 2 * 6, 10 * 2 * 6)
    assert (fb, bb) == (4 * 16 + 16, 8 * 16 + 16)


def test_block_cost_by_hand():
    # 2x2 pixels, 1 -> 1 channel, enc flavour, no skip: two convs of 27 taps.
    flops, nbytes = costs.block_cost((2, 1, 1, 1, "enc", False), "bfloat16")
    assert flops == 2 * 4 * (27 + 27) == 432
    assert nbytes == (4 + 16 + 1 + 12 + 54) * 2 + 8 == 182
    assert costs.block_bound_s((2, 1, 1, 1, "enc", False), 1) == pytest.approx(
        max(432 / 989e12, 182 / 3.35e12))


def test_train_step_cost_is_three_forwards_but_the_input_conv():
    cfg = dict(img_resolution=8, img_channels=2, label_dim=0, model_channels=4,
               channel_mult=[1], num_blocks=1, video_attn_resolutions=[8],
               frame_attn_resolutions=[], channels_per_head=4)
    rows = costs._forward_products(cfg, 1, 2, False)
    first = [v for k, v in rows if k == "input_conv"]
    assert len(first) == 1
    total = sum(v for _, v in rows)
    assert costs.train_step_cost(cfg, 1, 2, False) == 3 * total - first[0]
