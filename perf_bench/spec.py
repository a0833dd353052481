"""The model's layer table, read from a configuration file's `model` entry.

A frozen restatement of the denoiser's layout (the UNet's block table), so
that the cost model and the plain reference need nothing of the program:
`layout(cfg)` lists every layer in execution order with its resolution,
channels, flavour, resampling and attention kind. `cfg` is the dict of
UNet sizes a configuration file holds under "model".
"""
from __future__ import annotations

DEFAULTS = dict(label_dim=0, channel_mult_noise=None, channel_mult_emb=None,
                label_balance=0.5, concat_balance=0.5, channels_per_head=64,
                res_balance=0.3, attn_balance=0.3, clip_act=256.0, max_frames=64)


def full(cfg: dict) -> dict:
    """cfg with every size it leaves out at its default."""
    return {**DEFAULTS, **cfg}


def cblock(cfg):
    return [cfg["model_channels"] * m for m in cfg["channel_mult"]]


def cnoise(cfg):
    m = cfg.get("channel_mult_noise")
    return cfg["model_channels"] * m if m is not None else cblock(cfg)[0]


def cemb(cfg):
    m = cfg.get("channel_mult_emb")
    return cfg["model_channels"] * m if m is not None else max(cblock(cfg))


def attn_kind(cfg, res):
    if res in cfg["video_attn_resolutions"]:
        return "video"
    return "frame" if res in cfg["frame_attn_resolutions"] else None


def heads(cfg, spec) -> int:
    return spec["cout"] // full(cfg)["channels_per_head"] if spec.get("attention") else 0


def layout(cfg):
    """[(side, name, spec)] in execution order: side 'enc' | 'dec' | 'out';
    spec = dict(cin, cout, res, kind 'conv' | 'block', and for a block
    flavor 'enc' | 'dec', resample 'keep' | 'down' | 'up', attention
    'video' | 'frame' | None)."""
    out = []
    cout = cfg["img_channels"] + 1
    levels = cblock(cfg)
    nb = cfg["num_blocks"]
    for level, channels in enumerate(levels):
        res = cfg["img_resolution"] >> level
        if level == 0:
            cin, cout = cout, channels
            out.append(("enc", f"{res}x{res}_conv", dict(cin=cin, cout=cout, res=res, kind="conv")))
        else:
            out.append(("enc", f"{res}x{res}_down",
                        dict(cin=cout, cout=cout, res=res, kind="block", flavor="enc",
                             resample="down", attention=None)))
        for idx in range(nb):
            cin, cout = cout, channels
            out.append(("enc", f"{res}x{res}_block{idx}",
                        dict(cin=cin, cout=cout, res=res, kind="block", flavor="enc",
                             resample="keep", attention=attn_kind(cfg, res))))
    skips = [spec["cout"] for (_, _, spec) in out]
    for level, channels in reversed(list(enumerate(levels))):
        res = cfg["img_resolution"] >> level
        if level == len(levels) - 1:
            out.append(("dec", f"{res}x{res}_in0",
                        dict(cin=cout, cout=cout, res=res, kind="block", flavor="dec",
                             resample="keep", attention="video")))
            out.append(("dec", f"{res}x{res}_in1",
                        dict(cin=cout, cout=cout, res=res, kind="block", flavor="dec",
                             resample="keep", attention=None)))
        else:
            out.append(("dec", f"{res}x{res}_up",
                        dict(cin=cout, cout=cout, res=res, kind="block", flavor="dec",
                             resample="up", attention=None)))
        for idx in range(nb + 1):
            cin = cout + skips.pop()
            cout = channels
            out.append(("dec", f"{res}x{res}_block{idx}",
                        dict(cin=cin, cout=cout, res=res, kind="block", flavor="dec",
                             resample="keep", attention=attn_kind(cfg, res))))
    out.append(("out", "out_conv", dict(cin=cout, cout=cfg["img_channels"],
                                        res=cfg["img_resolution"], kind="conv")))
    return out


def decode_blocks(cfg):
    """[(H, Cin, C0, Co, flavor, has_skip)] of the Blocks that a cached T = 1
    call runs as one fused decode-Block kernel each: the attention-free ones."""
    out = []
    for _, _, spec in layout(cfg):
        if spec["kind"] == "block" and spec["attention"] is None:
            cin, co = spec["cin"], spec["cout"]
            c0 = co if spec["flavor"] == "enc" else cin
            out.append((spec["res"], cin, c0, co, spec["flavor"], cin != co))
    return out


def conv_calls(cfg):
    """[(H, C, Co, has_cvec)] of every causal conv, in execution order: the
    shapes the train-mode fused conv runs at."""
    out = []
    for _, _, spec in layout(cfg):
        r, cin, co = spec["res"], spec["cin"], spec["cout"]
        if spec["kind"] == "conv":
            out.append((r, cin, co, False))
        else:
            c0 = co if spec["flavor"] == "enc" else cin
            out.append((r, c0, co, False))
            out.append((r, co, co, True))
    return out
