"""Time the temporal block's two launches at every column tile a width
admits, on one card, in turns.

    python3 -m endodav_tpu_torch.bench.column_tiles [--shapes 1024x1702,384x437,...]

For each (C, rows) of `chip_smoke.py`'s TEMPORAL_SHAPES (T=32, 8 heads),
in f32 and bf16, the block runs with each column tile bn in (256, 192,
64) that divides C in at most 8 blocks a cluster (the heads a K step
as `tile_config` picks them), all on the same inputs and timed in turns
(`chip_smoke.time_calls`: each tile, then each in reverse order).  Prints
the card's name and power limit first, then one JSON line a shape and
dtype: ms and the error against `grouped_reference_block` for each tile,
and the tile `tile_config` picks.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
from unittest import mock

import torch

import chip_smoke as smoke
from endodav_tpu_torch.kernels import fused_temporal_block as ftb
from endodav_tpu_torch.models.motion import sinusoidal_time_encoding

TILES = (256, 192, 64)


def tiles_of(c: int) -> list[int]:
    return [bn for bn in TILES if c % bn == 0 and c // bn <= 8]


def run_shape(device, c: int, nrows: int, t: int = 32, heads: int = 8) -> list[dict]:
    g = torch.Generator(device=device).manual_seed(smoke.SEED + 1)
    f = lambda *s, sd=1.0: torch.randn(s, generator=g, device=device) * sd  # noqa: E731
    x = f(nrows, t, c, sd=0.5)
    gamma, beta = 1.0 + f(c, sd=0.1), f(c, sd=0.1)
    pe = torch.from_numpy(sinusoidal_time_encoding(32, c)[:t]).to(device)
    ws = [f(c, c, sd=c ** -0.5) for _ in range(4)]
    bo = f(c, sd=0.1)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        args = [a.to(dtype) for a in (x, *ws, bo)]
        xd, wq, wk, wv, wo, bod = args
        ref = [a.float() for a in args]
        want = ftb.grouped_reference_block(ref[0], gamma, beta, pe, *ref[1:5], ref[5], heads)
        picked, hs = ftb.tile_config(c, heads, dtype)

        def call(bn):
            with mock.patch.object(ftb, "tile_config", lambda *_: (bn, hs)):
                return ftb.fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads)

        row = {"shape": f"rows={nrows} T={t} C={c}", "dtype": str(dtype)[6:], "picked": picked,
               "hs": hs}
        for bn in tiles_of(c):
            row[f"err_{bn}"] = (call(bn).float() - want).abs().max().item()
        times = smoke.time_calls({bn: (lambda bn=bn: call(bn)) for bn in tiles_of(c)})
        row.update({f"ms_{bn}": ms for bn, ms in times.items()})
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(f"{c}x{r}" for c, r in smoke.TEMPORAL_SHAPES),
                    help="comma-separated CxROWS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("column_tiles: needs a CUDA card")
    print(smoke.card_line())
    device = torch.device("cuda", 0)
    with smoke.ieee_f32():
        for spec in args.shapes.split(","):
            c, nrows = map(int, spec.split("x"))
            for row in run_shape(device, c, nrows):
                print("[column tiles] " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
