"""gstex-torch-viewer: serve the interactive viewer on a trained run
(counterpart of ``gstex-viewer``, ``gstex_tpu/scripts/viewer.py``).

    python -m gstex_torch.scripts.viewer --load-config RUN_DIR [--port P]

The run is rebuilt by ``eval_setup`` (its latest checkpoint, on the card
unless ``--device`` says otherwise) and served without training: live
frames of any camera, the eval image set's outputs, texture painting and
camera paths (``gstex_torch/viewer/server.py``), until interrupted.
"""

from __future__ import annotations

import argparse
import time


def start(argv=None):
    """Parse the flags, rebuild the run and start its viewer; returns the
    running ``Viewer`` (its ``port`` the one bound; ``close()`` stops
    it)."""
    p = argparse.ArgumentParser(
        description="Serve the interactive viewer on a trained run.")
    p.add_argument("--load-config", required=True,
                   help="run directory, or its config.json")
    p.add_argument("--port", type=int, default=7007,
                   help="HTTP port (0: a free one)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from .eval_setup import eval_setup

    trainer, _, _ = eval_setup(args.load_config, device=args.device)
    return trainer.attach_viewer(port=args.port)


def main(argv=None):
    viewer = start(argv)
    print("viewer running; ctrl-c to exit", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()


if __name__ == "__main__":
    main()
