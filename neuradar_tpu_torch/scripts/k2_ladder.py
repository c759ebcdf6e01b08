"""K2's design ladder on the card: the committed kernels beside probes of their design, timed in turns.

    python -m neuradar_tpu_torch.scripts.k2_ladder [--baseline NAME=PATH ...] [--reps 20]

Each variant is ``csrc/attention.cu`` with a few lines replaced (``VARIANTS``), built by nvcc into
its own library under ``build/k2_ladder/`` and launched like the port's kernels; ``--baseline``
adds another source with the same C interface as it stands (an earlier commit's attention.cu, for
example). The variants are probes of what holds the kernels back, not alternatives: "1xtf32" and
"3mma-unsplit" compute other numbers (one TF32 product is not accurate enough for the port, see
tests/test_torch_attention_tc.py). Rows: K2 forward at the render path's [4, 3531, 48] (rate 0)
and at the train path's [16, 3531, 48] (rate 0.1 and 0), and the backward at the train shape
(rate 0.1 and 0). ``ms`` is the device time alone (utils/timing.device_ms: ``--reps`` launches
queued behind a spin of the card, one event pair) and ``call_ms`` one launch's time with its host
work (an event pair around each launch, the median); each variant runs a row in turn, in order
and then in reverse, and a row's times are the medians over both turns. One JSON line per variant
and row, with the max abs error against the plain version; the first line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from neuradar_tpu_torch.ops import attention, build
from neuradar_tpu_torch.utils.timing import call_ms, device_ms

SOURCE = build.CSRC / "attention.cu"
OUT_DIR = build.BUILD_DIR.parent / "k2_ladder"
SPLIT = """  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));"""
MMA3 = """  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);"""
INT_RNA = "{ return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }"
# name -> (what it probes, [(committed text, replacement)])
VARIANTS = {
    "committed": ("3xTF32 mma.sync, operands split by integer rounding", []),
    "cvt-rna": ("the split by the cvt.rna.tf32.f32 instruction (the first design)",
                [(INT_RNA, '{ uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r; }')]),
    "3mma-unsplit": ("three mma per product, operands passed unsplit: the split's ALU cost",
                     [(SPLIT, "  big = small = __float_as_uint(x);")]),
    "1xtf32": ("one TF32 mma per product and no small parts: the compensation's whole cost",
               [(SPLIT, "  big = tf32_rna(x);\n  small = 0u;"), (MMA3, "  mma_tf32(c, a.big, b.big);")]),
}
B_RENDER, B_TRAIN, S, D = 4, 16, 3531, 48
ROWS = (  # (row, kernel, batch, dropout rate)
    ("fwd render", "fwd", B_RENDER, 0.0),
    ("fwd train", "fwd", B_TRAIN, 0.1),
    ("fwd train, rate 0", "fwd", B_TRAIN, 0.0),
    ("bwd train", "bwd", B_TRAIN, 0.1),
    ("bwd train, rate 0", "bwd", B_TRAIN, 0.0),
)
SEED = 1234


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    return text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another source of csrc/attention.cu's C interface, built as it is")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_ladder measures the card; no CUDA device here")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)

    sources = {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name in VARIANTS:
        path = OUT_DIR / f"attention_{name}.cu"
        path.write_text(variant_source(name))
        sources[name] = path
    for spec in args.baseline:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).resolve()
    libs = build.build_each(sources, OUT_DIR)
    about = {**{n: VARIANTS[n][0] for n in VARIANTS}, **{spec.split("=", 1)[0]: spec for spec in args.baseline}}

    gen = torch.Generator(device=device).manual_seed(0)
    for row, kernel, B, rate in ROWS:
        q, k, v, dout = (torch.randn((B, S, D), generator=gen, device=device) for _ in range(4))
        if kernel == "fwd":
            want = (attention.attention_reference(q, k, v, SEED, rate),)
        else:
            want = attention.attention_bwd_reference(q, k, v, dout, SEED, rate)
        out, lse = attention.launch_fwd(build.load(), q, k, v, rate, SEED, True)

        def run(lib):
            if kernel == "fwd":
                return attention.launch_fwd(lib, q, k, v, rate, SEED, False)[:1]
            return attention.launch_bwd(lib, q, k, v, out, dout, lse, rate, SEED)

        errs = {n: max(float((g - w).abs().max()) for g, w in zip(run(lib), want)) for n, lib in libs.items()}
        times = {n: [] for n in libs}
        calls = {n: [] for n in libs}
        for order in (list(libs), list(reversed(libs))):
            for n in order:
                times[n].append(device_ms(lambda: run(libs[n]), args.reps))
                calls[n].append(call_ms(lambda: run(libs[n]), args.reps))
        for n in libs:
            print(json.dumps({"variant": n, "probes": about[n], "row": row, "shape": [B, S, D], "dropout": rate,
                              "ms": statistics.median(times[n]), "turns_ms": times[n],
                              "call_ms": statistics.median(calls[n]), "max_abs_err": errs[n]}), flush=True)
        del q, k, v, dout, want, out, lse
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
