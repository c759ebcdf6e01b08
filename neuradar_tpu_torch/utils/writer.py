"""Event writer: scalars to ``events.jsonl`` and a terminal line, scalars and images to TensorBoard
event files, images to PNGs (the port's copy of the JAX package's utils/writer.py)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

from neuradar_tpu_torch.utils.tb_writer import TBEventWriter, encode_png


class EventWriter:
    def __init__(self, log_dir: Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = log_dir / "events.jsonl"
        self._tb = TBEventWriter(log_dir / "tb")
        self._t0 = time.time()

    def put_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": step, "wall_time": time.time() - self._t0}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        for k, v in record.items():
            if k not in ("step", "wall_time"):
                self._tb.add_scalar(k, v, step)
        keys = ("loss", "psnr", "train_rays_per_sec", "radar_loss", "depth_loss")
        shown = " ".join(f"{k}={record[k]:.4g}" for k in keys if k in record)
        print(f"[step {step:6d}] {shown}", flush=True)

    def put_image(self, step: int, name: str, image) -> None:
        """A PNG under <log_dir>/images and a TensorBoard image; uint8 or [0, 1] float [H, W, 3]."""
        out_dir = self.log_path.parent / "images"
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{name}_{step:06d}.png").write_bytes(encode_png(image))
        self._tb.add_image(name, image, step)

    def close(self) -> None:
        self._tb.close()
