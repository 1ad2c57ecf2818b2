"""gstex-torch-export: export a trained run's scene.

The counterpart of ``gstex-export`` (the reference's ``ns-export``,
``nerfstudio/scripts/exporter.py``). It rebuilds the run from its
directory (``scripts/eval_setup.py``) and writes one of

- ``gstex-ply``: a point a gaussian, coloured by its chart's average
  albedo;
- ``gstex-npz``: every parameter, the active texels as the reference's
  flat jagged texture with its dims, the mappings and the pixel scale
  (``gstex-torch-render --scene-npz`` and ``gstex-torch-train
  --scene-npz`` read it, and so does the JAX package's
  ``params_from_export_npz``);
- ``gaussian-ply``: a 2DGS gaussian ply, which ``--init-ply`` reads.

    python -m gstex_torch.scripts.export gstex-npz \\
        --load-config outputs/RUN --output-path scene.npz
"""

from __future__ import annotations

import argparse

from ..models import init_io
from .eval_setup import eval_setup

WRITERS = {"gstex-ply": init_io.export_ply,
           "gstex-npz": init_io.export_npz,
           "gaussian-ply": init_io.export_gaussian_ply}


def main(argv=None) -> str:
    """Export; returns the path written."""
    p = argparse.ArgumentParser(description="Export a trained GStex run.")
    p.add_argument("kind", choices=list(WRITERS))
    p.add_argument("--load-config", required=True,
                   help="run directory, or its config.json")
    p.add_argument("--output-path", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    trainer, method, _ = eval_setup(args.load_config, device=args.device)
    st = trainer.state
    WRITERS[args.kind](args.output_path, st.params, st.buffers,
                       method.model.sh_degree)
    print(f"wrote {args.output_path}")
    return args.output_path


if __name__ == "__main__":
    main()
