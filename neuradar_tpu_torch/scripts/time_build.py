"""Time the build of the port's CUDA kernels two ways, on a machine with nvcc.

    python -m neuradar_tpu_torch.scripts.time_build [--reps 2]

``parallel`` is ``ops/build.build()``: one nvcc per source, all started
together, then one link. ``serial`` is one nvcc that compiles every source in
turn and links the library. Every build starts from nothing in a fresh
temporary directory; the two ways alternate (serial, parallel, parallel,
serial, ...) so that a drift of the machine falls on both. Each source is also
compiled alone once. Prints one JSON line of wall seconds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from neuradar_tpu_torch.ops import build


def _parallel(tmp: Path) -> None:
    build.BUILD_DIR = tmp
    build.build()


def _serial(tmp: Path) -> None:
    subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
                    *[str(build.CSRC / s) for s in build.SOURCES]], check=True, capture_output=True)


def _one_source(tmp: Path, name: str) -> None:
    subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-c", "-o", str(tmp / "k.o"), str(build.CSRC / name)],
                   check=True, capture_output=True)


def _seconds(fn, *args) -> float:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fn(Path(tmp), *args)
        return time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2, help="builds of each way")
    args = ap.parse_args(argv)
    times = {"serial": [], "parallel": []}
    for i in range(args.reps):
        for way in (("serial", "parallel") if i % 2 == 0 else ("parallel", "serial")):
            times[way].append(_seconds(_serial if way == "serial" else _parallel))
    alone = {name: _seconds(_one_source, name) for name in build.SOURCES}
    print(json.dumps({"phase": "build_time", "serial_s": times["serial"], "parallel_s": times["parallel"],
                      "compile_alone_s": alone}), flush=True)


if __name__ == "__main__":
    main()
