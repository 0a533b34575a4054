"""Serve streaming generation over HTTP (counterpart of the `--generate`
path of paddle_tpu/inference/serve.py):

    python -m paddle_tpu_torch.inference.serve --generate gpt3-medium \\
        --http 8000 [--state-dict CKPT] [--device cuda|cpu] ...

A GenerativeEngine over a models.gpt PRESET behind ServingHTTPServer
(/generate, /healthz, /metrics, and with --admin the /admin plane). The
model runs on the card unless --device says otherwise.

Without --state-dict the weights are the port's own seeded
initialisation (a torch.Generator seeded 0, drawn on the CPU, so the
same on every device): they are not the reference's demo weights, and
neither are its tokens. --state-dict reads a checkpoint that the
reference's `paddle_tpu.save(model.state_dict(), path)` wrote (a pickle
of {"__tensor__": True, "data": ndarray, ...} per parameter), or the
port's `framework_io.save` of `params_to_paddle_tpu(...)`, through
`framework_io.load` (numpy arrays only, bfloat16 ones included).

Refused, each naming the ROADMAP item that would port it: the pipe
worker of the C deployment ABI and the predict engine (a model prefix,
--engine, or no --generate: queue 4, after jit.save/load) and the
serving fabric (--fabric, --pool: queue 6).
"""
from __future__ import annotations

import argparse
import sys

_PREDICT_ITEM = "ROADMAP queue 4 (jit.save/load, then the predict engine)"
_FABRIC_ITEM = "ROADMAP queue 6 (the serving fabric's tiers)"


def load_reference_state_dict(path: str) -> dict:
    """{parameter name: CPU tensor} of a checkpoint that
    `paddle_tpu.save(model.state_dict(), path)` wrote."""
    import torch

    from ..framework_io import load

    obj = load(path)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state_dict (got "
                         f"{type(obj).__name__})")
    for name, ent in obj.items():
        if not isinstance(ent, torch.Tensor):
            raise ValueError(f"{path}: entry {name!r} is not a saved tensor")
    return {str(n): t for n, t in obj.items()}


def build_model(preset: str, state_dict, device):
    """The PRESET's GPTForCausalLM on `device`, in eval mode: the
    seeded initialisation drawn on the CPU, then the checkpoint's
    weights when `state_dict` (a path) is given."""
    import torch

    from ..framework_io import params_from_paddle_tpu
    from ..models import PRESETS, GPTForCausalLM

    model = GPTForCausalLM(PRESETS[preset], device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if state_dict:
        model.load_state_dict(params_from_paddle_tpu(
            load_reference_state_dict(state_dict)))
    return model.to(device).eval()


def main(argv=None) -> int:
    from ..models import PRESETS

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.inference.serve",
        description="serve streaming generation from a models.gpt preset "
                    "over HTTP (/generate, /healthz, /metrics)")
    ap.add_argument("prefix", nargs="?", default=None,
                    help="a saved model's path prefix: the predict "
                         f"engine, refused ({_PREDICT_ITEM})")
    ap.add_argument("--engine", action="store_true",
                    help=f"the predict engine: refused ({_PREDICT_ITEM})")
    ap.add_argument("--http", type=int, metavar="PORT", default=None,
                    help="serve HTTP on PORT (required)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--generate", metavar="PRESET", default=None,
                    help="serve streaming generation (/generate) from a "
                         "models.gpt PRESET (e.g. gpt3-tiny): the port's "
                         "seeded weights (not the reference's demo "
                         "weights, so not its tokens), or --state-dict")
    ap.add_argument("--state-dict", default=None,
                    help="a checkpoint for the --generate model (float32 "
                         "or bfloat16), as paddle_tpu.save(model."
                         "state_dict(), path) writes it")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode-batch capacity per worker")
    ap.add_argument("--draft", metavar="PRESET", default=None,
                    help="speculative decoding: a models.gpt draft preset "
                         "(e.g. tiny-draft, seeded weights) proposing "
                         "tokens the --generate model verifies")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="tokens per speculative burst (with --draft)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="prefix-cache rows per worker")
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default="f32",
                    help="KV pool precision: int8 rows with per-(row, "
                         "layer) absmax scales")
    ap.add_argument("--quantize-weights", action="store_true",
                    help="weight-only int8 for the model (and draft)")
    ap.add_argument("--admin", action="store_true",
                    help="mount the /admin plane (scale, drain, "
                         "/admin/kv handoff import); keep the port "
                         "private")
    ap.add_argument("--fabric", metavar="STORE", default=None,
                    help=f"join the serving fabric: refused "
                         f"({_FABRIC_ITEM})")
    ap.add_argument("--pool", default=None,
                    help=f"fabric pool role: refused ({_FABRIC_ITEM})")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu runs "
                         "it on the host)")
    args = ap.parse_args(argv)

    if args.prefix is not None or args.engine:
        ap.error(f"the predict engine is not ported: {_PREDICT_ITEM}")
    if args.fabric is not None or args.pool is not None:
        ap.error(f"the serving fabric is not ported: {_FABRIC_ITEM}")
    if args.generate is None:
        ap.error(f"need --generate PRESET (the pipe worker and the "
                 f"predict engine are not ported: {_PREDICT_ITEM})")
    if args.http is None:
        ap.error("--generate needs --http PORT (streaming rides HTTP)")
    for preset in (args.generate, args.draft):
        if preset is not None and preset not in PRESETS:
            ap.error(f"unknown preset {preset!r}; have {sorted(PRESETS)}")

    import torch

    from .serving import GenerativeEngine, ServingHTTPServer

    device = torch.device(args.device)
    model = build_model(args.generate, args.state_dict, device)
    draft = build_model(args.draft, None, device) if args.draft else None
    generator = GenerativeEngine(
        model, slots=args.slots, replicas=args.replicas or 1,
        max_queue_depth=args.max_queue_depth, draft=draft,
        spec_tokens=args.spec_tokens, prefix_cache_slots=args.prefix_cache,
        kv_dtype=args.kv_dtype, quantize_weights=args.quantize_weights,
        device=device)
    srv = ServingHTTPServer(host=args.host, port=args.http,
                            generator=generator, admin=args.admin)
    print(f"serving generate[{args.generate}] on {device} at "
          f"http://{srv.host}:{srv.port}", file=sys.stderr, flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
