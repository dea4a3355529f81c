"""CLI of the PyTorch port (counterpart of ``mla_tpu/__main__.py``). Only
the ``train`` verb is ported so far (ROADMAP.md queue A, item 10):

    python -m mla_tpu_torch train --config us8k_fused_frontend [--set k=v ...]
                                  [--workspace W] [--resume] [--device cpu]

It trains on the card (``--device cpu`` to ask for the CPU) and prints one
JSON line: the final logged loss and the last eval stats.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _jdump(obj) -> str:
    """Strict-JSON dumps: non-finite floats (e.g. d' = inf at AUC 1.0)
    become strings so downstream parsers do not choke on 'Infinity'."""

    def clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    return json.dumps(clean(obj))


def _parse_sets(pairs):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_train(args):
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.train.loop import fit

    cfg = get_config(args.config, _parse_sets(args.set))
    result = fit(cfg, workspace=args.workspace, auto_resume=args.resume, device=args.device)
    last_eval = result.eval_stats[-1] if result.eval_stats else {}
    print(_jdump({"final_loss": result.history[-1]["loss"] if result.history else None,
                  **last_eval,
                  **({"interrupted": True} if result.interrupted else {})}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="mla_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("train", help="train per config")
    st.add_argument("--config", default="esc50_single_attention")
    st.add_argument("--workspace", default=None)
    st.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint and continue")
    st.add_argument("--set", nargs="*")
    st.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    st.set_defaults(fn=cmd_train)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
