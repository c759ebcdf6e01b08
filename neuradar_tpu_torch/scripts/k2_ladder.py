"""K2's design ladder on the card: the committed kernels beside probes of their design and earlier
versions, timed in turns.

    python -m neuradar_tpu_torch.scripts.k2_ladder [--source attention_bf16.cu] [--baseline NAME=PATH ...]
                                                   [--reps 20]

``--source`` picks the kernel: ``attention_bf16.cu`` (the default; K2 at bf16, wgmma on TMA tiles)
or ``attention.cu`` (float32, 3xTF32 mma.sync). Each variant is the source with a few lines
replaced (``VARIANTS``), built by nvcc into its own library under ``build/k2_ladder/`` and launched
like the port's kernels; ``--baseline`` adds another source with the same C interface as it stands
(an earlier commit's file, for example). The variants are probes of what holds the kernels back:
the float32 "1xtf32" and "3mma-unsplit" compute other numbers (one TF32 product is not accurate
enough for the port, see tests/test_torch_attention_tc.py); the bf16 ones compute the committed
kernels' numbers in another schedule, and every row says whether a variant's outputs are bit-equal
to the committed kernel's. Rows: for bf16, the forward and the backward at a radar decode group of
the train path, [4, 3531, 48], with dropout 0.1 and 0 (the difference prices the dropout hash), and
at one scan, [1, 3531, 48], rate 0; beside them SDPA at bf16 with the same dropout (the library
call; its backward through autograd). For float32 the forward at the render path's [4, 3531, 48]
(rate 0) and at [16, 3531, 48] (rate 0.1 and 0), and the backward at [16, 3531, 48] (rate 0.1 and 0).
``ms`` is the device time alone (utils/timing.device_ms: ``--reps`` launches queued behind a spin
of the card, one event pair) and ``call_ms`` one launch's time with its host work (an event pair
around each launch, the median); each variant runs a row in turn, in order and then in reverse,
and a row's times are the medians over both turns. One JSON line per variant and row, with the max
abs error against the plain version, and one line per row with the committed kernels' device times
one by one (``kernels_ms``, from a torch.profiler trace); the first line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from neuradar_tpu_torch.ops import attention, build
from torch.profiler import ProfilerActivity, profile

from neuradar_tpu_torch.utils.timing import call_ms, device_ms

OUT_DIR = build.BUILD_DIR.parent / "k2_ladder"
SPLIT = """  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));"""
MMA3 = """  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);"""
INT_RNA = "{ return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }"
NEXT_SCORES = "    issue_scores<D>(next, my_q, kv + sn * 2 * T);\n"
SETMAXNREG = '  asm volatile("setmaxnreg.{}.sync.aligned.u32 %0;\\n" ::"n"(N));'
# source -> name -> (what it probes, [(committed text, replacement)])
VARIANTS = {
    "attention.cu": {
        "committed": ("3xTF32 mma.sync, operands split by integer rounding", []),
        "cvt-rna": ("the split by the cvt.rna.tf32.f32 instruction (the first design)",
                    [(INT_RNA, '{ uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r; }')]),
        "3mma-unsplit": ("three mma per product, operands passed unsplit: the split's ALU cost",
                         [(SPLIT, "  big = small = __float_as_uint(x);")]),
        "1xtf32": ("one TF32 mma per product and no small parts: the compensation's whole cost",
                   [(SPLIT, "  big = tf32_rna(x);\n  small = 0u;"), (MMA3, "  mma_tf32(c, a.big, b.big);")]),
    },
    "attention_bf16.cu": {
        "committed": ("wgmma on TMA tiles, 2 consumer warpgroups a block, the forward's next scores beside its "
                      "softmax, the backward's warpgroups in turns", []),
        "one-group": ("1 consumer warpgroup a block, 2 blocks an SM (the same products, twice the tile copies)",
                      [("constexpr int kGroups = 2;", "constexpr int kGroups = 1;")]),
        "serial-scores": ("the forward's next-tile scores waited for at once: what the overlap buys",
                          [(NEXT_SCORES, NEXT_SCORES + "    wgmma_wait<0>();\n")]),
        "stages-2": ("2 stages in the ring instead of 3: whether the copies keep ahead",
                     [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
        "stages-4": ("4 stages in the ring instead of 3", [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
        "no-turns": ("the backward's two warpgroups issue their products when ready, not in turns",
                     [("constexpr bool kTakeTurns = true;", "constexpr bool kTakeTurns = false;")]),
        "no-setmaxnreg": ("no register hand-off from the producer: 168 registers a thread (65,536 / 384)",
                          [(SETMAXNREG.format("dec"), ""), (SETMAXNREG.format("inc"), "")]),
    },
}
SEED = 1234
# (row, kernel, batch, dropout rate) at S = 3531, D = 48
ROWS = {
    "attention.cu": (("fwd render", "fwd", 4, 0.0), ("fwd train", "fwd", 16, 0.1),
                     ("fwd train, rate 0", "fwd", 16, 0.0), ("bwd train", "bwd", 16, 0.1),
                     ("bwd train, rate 0", "bwd", 16, 0.0)),
    "attention_bf16.cu": (("fwd train_bf16", "fwd", 4, 0.1), ("fwd train_bf16, rate 0", "fwd", 4, 0.0),
                          ("fwd one scan, rate 0", "fwd", 1, 0.0), ("bwd train_bf16", "bwd", 4, 0.1),
                          ("bwd train_bf16, rate 0", "bwd", 4, 0.0), ("bwd one scan, rate 0", "bwd", 1, 0.0)),
}
S, D = 3531, 48


def kernel_split_ms(fn, reps: int = 10) -> dict:
    """Device ms of one call of ``fn``, kernel by kernel (their names without the C++ decoration)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"attention(?:_bf16)?_(?:fwd_kernel|bwd_delta|bwd_dkdv|bwd_dq)", a.key)
            key = name.group(0) if name else a.key[:60]
            split[key] = split.get(key, 0.0) + a.self_device_time_total / 1e3 / reps
    return split


def variant_source(source: str, name: str) -> str:
    path = build.CSRC / source
    text = path.read_text()
    for old, new in VARIANTS[source][name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {path} exactly once")
        text = text.replace(old, new)
    return text


def _runner(source: str, kernel: str, q, k, v, dout, rate: float):
    """lib -> the kernel's outputs on these inputs, and the library call (SDPA) for bf16."""
    if source == "attention.cu":
        out, lse = attention.launch_fwd(build.load(), q, k, v, rate, SEED, True)
        if kernel == "fwd":
            return lambda lib: attention.launch_fwd(lib, q, k, v, rate, SEED, False)[:1], None
        return lambda lib: attention.launch_bwd(lib, q, k, v, out, dout, lse, rate, SEED), None
    out, lse, out32 = attention.launch_bf16_fwd(build.load(), q, k, v, rate, SEED, True, True)
    qh, kh, vh = (t[:, None].clone().requires_grad_(kernel == "bwd") for t in (q, k, v))
    if kernel == "fwd":
        return (lambda lib: attention.launch_bf16_fwd(lib, q, k, v, rate, SEED, False, False)[:1],
                lambda: F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate)
    return (lambda lib: attention.launch_bf16_bwd(lib, q, k, v, out32, dout, lse, rate, SEED),
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dout[:, None], retain_graph=True))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", choices=tuple(VARIANTS), default="attention_bf16.cu")
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another source of the same C interface, built as it is")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_ladder measures the card; no CUDA device here")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__, "source": args.source}), flush=True)

    variants = VARIANTS[args.source]
    sources = {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = Path(args.source).stem
    for name in variants:
        path = OUT_DIR / f"{stem}_{name}.cu"
        path.write_text(variant_source(args.source, name))
        sources[name] = path
    for spec in args.baseline:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).resolve()
    libs = build.build_each(sources, OUT_DIR / stem)
    about = {**{n: variants[n][0] for n in variants}, **{spec.split("=", 1)[0]: spec for spec in args.baseline}}
    dtype = torch.bfloat16 if args.source == "attention_bf16.cu" else torch.float32

    gen = torch.Generator(device=device).manual_seed(0)
    for row, kernel, B, rate in ROWS[args.source]:
        q, k, v, dout = (torch.randn((B, S, D), generator=gen, device=device).to(dtype) for _ in range(4))
        if kernel == "fwd":
            want = (attention.attention_reference(q, k, v, SEED, rate),)
        else:
            want = attention.attention_bwd_reference(q, k, v, dout, SEED, rate)
        run, library = _runner(args.source, kernel, q, k, v, dout, rate)
        outs = {n: run(lib) for n, lib in libs.items()}
        errs = {n: max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
                for n, got in outs.items()}
        equal = {n: all(torch.equal(a, b) for a, b in zip(got, outs["committed"])) for n, got in outs.items()}
        timed = {**{n: (lambda lib=lib: run(lib)) for n, lib in libs.items()},
                 **({"sdpa": library} if library is not None else {})}
        times = {n: [] for n in timed}
        calls = {n: [] for n in timed}
        for order in (list(timed), list(reversed(timed))):
            for n in order:
                times[n].append(device_ms(timed[n], args.reps))
                calls[n].append(call_ms(timed[n], args.reps))
        for n in timed:
            line = {"variant": n, "probes": about.get(n, "SDPA at bf16, the library call"), "row": row,
                    "shape": [B, S, D], "dropout": rate, "ms": statistics.median(times[n]),
                    "turns_ms": times[n], "call_ms": statistics.median(calls[n])}
            if n in libs:
                line.update(max_abs_err=errs[n], bit_equal_to_committed=equal[n])
            print(json.dumps(line), flush=True)
        print(json.dumps({"variant": "committed", "row": row, "shape": [B, S, D], "dropout": rate,
                          "kernels_ms": kernel_split_ms(timed["committed"])}), flush=True)
        del q, k, v, dout, want, outs, run, library, timed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
