"""gstex-torch-completions: bash completions over the port's CLIs
(counterpart of ``gstex_tpu/scripts/completions.py``).

Builds each ``gstex-torch-*`` CLI's argparse parser without running the
command, reads its flags and its positional choices, and writes a bash
completion script: to ``--output`` where given, else to standard output
(``gstex-torch-completions > FILE``, then ``source FILE``). ``--install``
also adds a line sourcing ``--output`` to ``~/.bashrc``.
"""

from __future__ import annotations

import argparse
import importlib
import unittest.mock as mock
from pathlib import Path

# entry point -> the module whose main(argv) builds its parser
CLIS = {
    "gstex-torch-train": "gstex_torch.scripts.train",
    "gstex-torch-eval": "gstex_torch.scripts.eval",
    "gstex-torch-render": "gstex_torch.scripts.render",
    "gstex-torch-export": "gstex_torch.scripts.export",
    "gstex-torch-viewer": "gstex_torch.scripts.viewer",
    "gstex-torch-parity": "gstex_torch.scripts.parity",
    "gstex-torch-experiments": "gstex_torch.scripts.experiments",
    "gstex-torch-completions": "gstex_torch.scripts.completions",
    "gstex-torch-dev-test": "gstex_torch.scripts.dev_test",
}


class _Parsed(Exception):
    """Raised in place of parsing, once the CLI has built its parser."""


def collect_options(module_name: str) -> tuple[list[str], list[str]]:
    """``(flags, positional choices)`` of the CLI in ``module_name``: its
    ``main`` runs until it parses its arguments, which is stopped there."""
    captured = {}

    def stop(self, args=None, namespace=None):
        captured["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", stop):
        try:
            importlib.import_module(module_name).main([])
        except _Parsed:
            pass
    parser = captured["parser"]
    opts, positionals = [], []
    for a in parser._actions:
        if a.option_strings:
            opts.extend(a.option_strings)
        elif a.choices:
            positionals.extend(str(c) for c in a.choices)
    return sorted(set(opts)), sorted(set(positionals))


def generate_script() -> str:
    lines = ["# gstex_torch bash completions (generated by "
             "gstex-torch-completions)"]
    for cli, module in CLIS.items():
        opts, positionals = collect_options(module)
        words = " ".join(positionals + opts)
        fn = cli.replace("-", "_") + "_complete"
        lines += [
            f"_{fn}() {{",
            "  local cur=${COMP_WORDS[COMP_CWORD]}",
            f"  COMPREPLY=( $(compgen -W \"{words}\" -- \"$cur\") )",
            "}",
            f"complete -F _{fn} {cli}",
        ]
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Write bash completions for the gstex-torch-* CLIs.")
    p.add_argument("--output", default=None,
                   help="file to write (default: standard output)")
    p.add_argument("--install", action="store_true",
                   help="also add a line sourcing --output to ~/.bashrc")
    args = p.parse_args(argv)
    if args.install and args.output is None:
        p.error("--install needs --output")
    text = generate_script()
    if args.output is None:
        print(text, end="")
        return text
    out = Path(args.output).expanduser()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"wrote {out}")
    if args.install:
        rc = Path("~/.bashrc").expanduser()
        line = f"source {out}"
        if line not in (rc.read_text() if rc.exists() else ""):
            with open(rc, "a") as f:
                f.write(f"\n# gstex_torch completions\n{line}\n")
            print(f"added a source line to {rc}")
    return text


if __name__ == "__main__":
    main()
