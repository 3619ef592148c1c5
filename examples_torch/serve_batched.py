#!/usr/bin/env python3
"""Batched serving example: both serving modes of
``repro_torch.launch.serve``, the counterpart of ``examples/serve_batched.py``.

LM mode (``--arch``): prefill a batch of prompts, then run the greedy
decode loop over its caches (KV caches, MLA's latent, the recurrent
states of Mamba and RWKV), every attention in the ``flash_attention``
kernel; every arch of ``configs.registry.ARCHS`` runs.

  PYTHONPATH=src python examples_torch/serve_batched.py --arch qwen3-8b \\
      --reduced [--device cpu]

GNN mode (``--gnn``): drain a graph request queue through fixed-shape
packed GraphBatch programs, optionally on ``--shards`` ranks of one
``torch.distributed`` group.

  PYTHONPATH=src python examples_torch/serve_batched.py --gnn --conv gcn \\
      --requests 256 [--shards 2] [--device cpu]

Without ``--device cpu`` both run on the card and raise on a host with
none. One of ``--arch`` and ``--gnn`` is required.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.convs import CONV_TYPES  # noqa: E402
from repro_torch.core.quantization import PRECISIONS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--arch", choices=list(ARCHS))
    mode.add_argument("--gnn", action="store_true",
                      help="packed GraphBatch GNN serving instead of LM "
                           "decode")
    ap.add_argument("--reduced", action="store_true",
                    help="the small config (LM: the arch's reduced())")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--conv", default="gcn", choices=list(CONV_TYPES))
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--precision", default="fp32", choices=PRECISIONS)
    ap.add_argument("--shards", type=int, default=1,
                    help="ranks of one torch.distributed group")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common = ["--device", args.device] + (["--reduced"] if args.reduced
                                          else [])
    if args.gnn:
        return serve.main(["--gnn", "--conv", args.conv,
                           "--requests", str(args.requests),
                           "--batch-graphs", str(args.batch_graphs),
                           "--precision", args.precision,
                           "--shards", str(args.shards)] + common)
    return serve.main(["--arch", args.arch, "--batch", str(args.batch),
                       "--prompt-len", "32", "--gen", str(args.gen)]
                      + common)


if __name__ == "__main__":
    main()
