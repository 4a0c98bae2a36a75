"""Command line of the port.

    python -m polyaxon_tpu_torch serve -m llama-1b --attn-impl flash

runs the serving runtime locally (the same engine and routes as a
``kind: service`` replica, no control plane). It serves on CUDA unless
``--platform cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="run the online inference runtime")
    s.add_argument("--model", "-m", default="llama-tiny",
                   help="model zoo name (causal LM families only)")
    s.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, restored read-only; "
                        "absent: random init")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--bind", default="127.0.0.1")
    s.add_argument("--max-slots", type=int, default=8,
                   help="continuous-batching decode slots")
    s.add_argument("--block-size", type=int, default=16,
                   help="KV cache block size (tokens)")
    s.add_argument("--max-seq-len", type=int, default=None)
    s.add_argument("--prefill-chunk", type=int, default=64)
    s.add_argument("--attn-impl", choices=("gather", "flash"),
                   default="gather",
                   help="decode attention: gathered dense math, or the "
                        "paged CUDA kernel")
    s.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return p


def serve_spec(args: argparse.Namespace) -> dict:
    spec = {"model": args.model, "port": args.port, "bind": args.bind,
            "max_slots": args.max_slots, "block_size": args.block_size,
            "prefill_chunk": args.prefill_chunk,
            "attn_impl": args.attn_impl, "platform": args.platform}
    if args.checkpoint:
        spec["checkpoint"] = args.checkpoint
    if args.max_seq_len:
        spec["max_seq_len"] = args.max_seq_len
    return spec


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.command == "serve":
        from .serve.runtime import run_serve

        run_serve(serve_spec(args))


if __name__ == "__main__":
    main(sys.argv[1:])
