"""Metric and image writers: JSONL, console, TensorBoard, wandb, comet
(counterpart of ``gstex_tpu/utils/writer.py``).

``events.jsonl`` and the console are always on: each ``scalars`` call
appends one ``{"step", "t", <scalars>}`` record (``t`` in seconds since
the writer opened), and prints a ``[step N] k=v ...`` line every
``console_every`` steps. ``image`` writes ``<out>/images/<name>_<step>.png``
with the port's own PNG writer. ``vis`` names further sinks, comma
separated: ``tensorboard`` (``torch.utils.tensorboard``; also on when
``vis`` is empty, as in the JAX package), ``wandb``, ``comet``. A sink
whose package does not import, or that cannot start, prints a one-line
notice and is skipped; the run goes on with the local sinks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..data.png import write_png


class _TensorBoardSink:
    def __init__(self, out_dir: Path):
        # raises ImportError where the tensorboard package is missing
        from torch.utils.tensorboard import SummaryWriter

        self.tb = SummaryWriter(str(out_dir / "tb"))

    def scalars(self, step, values):
        for k, v in values.items():
            self.tb.add_scalar(k, float(v), step)

    def image(self, step, name, arr):
        self.tb.add_image(name, arr, step, dataformats="HWC")

    def close(self):
        self.tb.close()


class _WandbSink:
    def __init__(self, out_dir: Path):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project="gstex-torch", dir=str(out_dir),
                              reinit=True)

    def scalars(self, step, values):
        self._wandb.log(dict(values), step=step)

    def image(self, step, name, arr):
        self._wandb.log({name: self._wandb.Image(arr)}, step=step)

    def close(self):
        self.run.finish()


class _CometSink:
    def __init__(self, out_dir: Path):
        import comet_ml

        self.exp = comet_ml.Experiment(project_name="gstex-torch")

    def scalars(self, step, values):
        self.exp.log_metrics(dict(values), step=step)

    def image(self, step, name, arr):
        self.exp.log_image(arr, name=name, step=step)

    def close(self):
        self.exp.end()


SINKS = {"tensorboard": _TensorBoardSink, "wandb": _WandbSink,
         "comet": _CometSink}


class Writer:
    def __init__(self, out_dir, console_every: int = 10,
                 vis: str = "tensorboard"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.out_dir / "events.jsonl", "a")
        self.console_every = console_every
        kinds = {k.strip() for k in (vis or "").split(",") if k.strip()}
        unknown = kinds - set(SINKS)
        if unknown:
            raise ValueError(f"unknown --vis sink(s) {sorted(unknown)}; "
                             f"have {sorted(SINKS)}")
        self.sinks = []
        for kind in sorted(kinds or {"tensorboard"}):
            try:
                self.sinks.append(SINKS[kind](self.out_dir))
            except Exception as e:  # package missing / not logged in
                print(f"[writer] {kind} unavailable ({type(e).__name__}); "
                      f"continuing with local sinks", flush=True)
        self._t0 = time.time()

    def scalars(self, step: int, values: dict):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        for sink in self.sinks:
            sink.scalars(step, values)
        if self.console_every and step % self.console_every == 0:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in values.items())
            print(f"[step {step:6d}] {parts}", flush=True)

    def image(self, step: int, name: str, img):
        """``img`` (H, W, 3): uint8, or floats in [0, 1] (a tensor on any
        device, or an array)."""
        if hasattr(img, "detach"):
            img = img.detach().cpu().numpy()
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        img_dir = self.out_dir / "images"
        img_dir.mkdir(exist_ok=True)
        write_png(img_dir / f"{name}_{step:09d}.png", arr)
        for sink in self.sinks:
            sink.image(step, name, arr)

    def close(self):
        self.jsonl.close()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass


class NullWriter:
    """A ``Writer`` that writes nothing: a rank other than 0 of a mesh."""

    def scalars(self, step: int, values: dict):
        pass

    def image(self, step: int, name: str, img):
        pass

    def close(self):
        pass
