"""gstex-torch-eval: score a trained run on its eval split.

The counterpart of ``gstex-eval`` (the reference's ``ns-eval``,
``nerfstudio/scripts/eval.py:32-62``). It rebuilds the run from its
directory (``scripts/eval_setup.py``), renders every eval view, and prints
and optionally writes the JAX package's JSON: ``experiment_name``,
``method_name``, ``checkpoint`` and ``results`` (``Trainer.eval_all``:
PSNR, SSIM and LPIPS means and stds, fps, rays per second, the gaussian
and texel counts and the pixel scale).

    python -m gstex_torch.scripts.eval --load-config outputs/RUN \\
        --output-path eval.json [--save-images] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .eval_setup import eval_setup, run_dir_of


def main(argv=None) -> dict:
    """Evaluate; returns the printed JSON as a dict."""
    p = argparse.ArgumentParser(
        description="Score a trained GStex run on its eval split.")
    p.add_argument("--load-config", required=True,
                   help="run directory, or its config.json")
    p.add_argument("--output-path", default=None)
    p.add_argument("--save-images", action="store_true",
                   help="write each eval render through the run's writer: "
                        "images/eval_all_rgb_<i>.png and the metric sinks")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    run_dir = run_dir_of(args.load_config)
    trainer, method, cfg = eval_setup(run_dir, device=args.device)
    if trainer.eval_cache is None:
        raise SystemExit(f"{cfg['data']} has no eval split to score")
    out = {
        "experiment_name": cfg.get("data"),
        "method_name": method.name,
        "checkpoint": str(run_dir / "checkpoints"),
        "results": trainer.eval_all(save_images=args.save_images),
    }
    text = json.dumps(out, indent=2)
    if args.output_path:
        Path(args.output_path).write_text(text)
    print(text)
    return out


if __name__ == "__main__":
    main()
