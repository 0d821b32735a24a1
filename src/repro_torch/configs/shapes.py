"""Assigned input-shape set (same for all 10 LM archs).

train/prefill lower `train_step`/`prefill`; decode_* / long_* lower
`serve_step` (one new token against a KV/state cache of seq_len).
`long_500k` requires sub-quadratic attention: it runs only for
recurrentgemma-2b (hybrid) and rwkv6-3b (SSM); the 8 pure full-attention
archs skip it (documented in DESIGN.md §Arch-applicability).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applies(cfg, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.is_subquadratic
    return True
