"""Style-transfer serving CLI for the PyTorch port: an HTTP endpoint over the
dynamic-batching engine, running the demo's min-latency plan on one card.

Counterpart of motionstyle/cli/serve.py. Requests carrying a normalised
content motion and a caption are coalesced into padded device batches,
sampled with the root_horizontal inpainting contract (DDIM-20, skip 700 of
1000, early-stopped at t=4: two denoiser calls per batch), and answered with
the transferred hml_vec motion. A request's `seed` pins its noise, so its
answer does not depend on co-batched traffic.

With --fused 1 every encoder layer runs the CUDA layer of kernel 1; with
--quant_int8 1 (which implies it) the int8 CUDA layer of kernel 2.

Run:  python -m motionstyle_torch.cli.serve --model_path save/.../model000000032.pt \\
        --dataset stylexia_posrot --fused 1 [--quant_int8 1] [--port 8500]

Request:  POST /v1/sample
  {"content": [[...T x C...]], "text": "a person walks angrily", "seed": 7}
  (or "content_b64": base64 of little-endian float32 (T, C))
Response: {"motion": [[...C x 1 x T...]], "seed": 7}

Not on this slice: /v1/stream and long-form content. --artifact, --styles,
--style_strength and --model_parallel are refused (NotImplementedError) when
they ask for anything but their defaults; a request naming a "style" is
refused as the JAX server refuses an unregistered one (HTTP 500, "unknown
style").
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

# flag, when it asks for something not ported, what it needs
REFUSED = (
    ("artifact", bool, "serving an exported artifact (ROADMAP §1 item 6)"),
    ("styles", bool, "named styles (ROADMAP §1 item 6)"),
    ("style_strength", lambda v: v != 1.0, "style strength (ROADMAP §1 item 6)"),
    ("model_parallel", lambda v: v > 1, "model-parallel serving (ROADMAP §1 item 11)"),
)

DATASET_DIMS = {"stylexia_posrot": (181, 76), "bandai-1_posrot": (190, 196),
                "bandai-2_posrot": (190, 196), "humanml": (263, 196),
                "kit": (251, 196)}


def build_sampler(args):
    """args -> (bundle, Sampler, item_shape, dump pick): the min-latency
    serving plan on args.device; --fused and --quant_int8 reach the model's
    config through model_util.get_transfer_config."""
    from motionstyle_torch.cli import model_util
    from motionstyle_torch.diffusion.sampling import min_latency_plan
    from motionstyle_torch.parallel.inference import Sampler

    njoints, nframes = DATASET_DIMS[args.dataset]
    bundle, sched_ddim, _ = model_util.creat_serval_diffusion(
        args, args.timestep_respacing, device=args.device)
    skip = int(args.skip_steps / args.diffusion_steps * sched_ddim.num_timesteps)
    stop, pick = min_latency_plan(sched_ddim.num_timesteps, skip)

    def builder(model):
        return lambda x, t_orig, cond: model(x, t_orig, cond.get("enc_text"))

    sampler = Sampler(sched_ddim, builder, bundle.model, method="ddim",
                      skip_timesteps=skip, stop_timesteps=stop, dump_all_xstart=True)
    return bundle, sampler, (njoints, 1, nframes), pick


def _payload_content(payload: dict, njoints: int) -> np.ndarray:
    """Request content as (T, C) float32 from "content" (JSON lists) or
    "content_b64" (base64 of raw little-endian float32, row-major (T, C))."""
    if "content_b64" in payload:
        if "content" in payload:
            raise ValueError("send content or content_b64, not both")
        import base64

        raw = base64.b64decode(payload["content_b64"])
        if not raw or len(raw) % (4 * njoints):
            raise ValueError(
                f"content_b64 must be raw float32 (frames, {njoints}) bytes; "
                f"got {len(raw)} bytes (not a multiple of {4 * njoints})")
        return np.frombuffer(raw, "<f4").reshape(-1, njoints)
    return np.asarray(payload["content"], np.float32)


def build_engine(args):
    """args -> (engine, decode, handle): decode turns a JSON payload into an
    engine Request, handle answers it."""
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.serve.engine import Request, ServingEngine

    njoints, nframes = DATASET_DIMS[args.dataset]
    bundle, sampler, item_shape, pick = build_sampler(args)
    engine = ServingEngine(sampler, item_shape, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, buckets=(1, 2, 4, 8),
                           deterministic=bool(args.deterministic),
                           max_queue=args.max_queue, dump_pick=pick)
    mask = np.asarray(get_inpainting_mask(
        args.inpainting_mask, (1,) + item_shape, dataset=args.dataset), np.float32)[0]

    def decode(payload: dict) -> Request:
        content = _payload_content(payload, njoints)  # (T, C)
        if content.shape != (nframes, njoints):
            raise ValueError(f"content must be (frames={nframes}, channels={njoints}), "
                             f"got {content.shape}")
        enc = bundle.encode_text([payload.get("text", "")], args.dataset)[0]
        return Request({"enc_text": enc}, init_image=content.T[:, None, :],
                       inpainting_mask=mask, seed=payload.get("seed", 0),
                       style=payload.get("style"))

    def handle(payload: dict) -> np.ndarray:
        return engine.sample(decode(payload))

    return engine, decode, handle


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to serve on (cuda unless asked)")
    parser.add_argument("--seed", default=10, type=int,
                        help="seed of the initialisation fallback")
    parser.add_argument("--noise_schedule", default="cosine", choices=["linear", "cosine"])
    parser.add_argument("--diffusion_steps", default=1000, type=int)
    parser.add_argument("--layers", default=8, type=int)
    parser.add_argument("--latent_dim", default=512, type=int)
    parser.add_argument("--mdm_path", default="", type=str,
                        help="pretrained MDM prior checkpoint (.pt)")
    parser.add_argument("--clip_weights", default="", type=str,
                        help="optional CLIP text-tower .pt; seeded if absent")
    parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                        help="transformer compute dtype; default float32, or "
                             "bfloat16 with --fused 1 or --quant_int8 1")
    parser.add_argument("--fused", default=0, type=int,
                        help="run the encoder layers through the fused CUDA kernel")
    parser.add_argument("--quant_int8", default=0, type=int,
                        help="int8 serving: run the encoder layers through the int8 CUDA "
                             "kernel (implies --fused 1)")
    parser.add_argument("--dataset", default="stylexia_posrot", type=str)
    parser.add_argument("--model_path", default="", type=str,
                        help="finetuned style checkpoint to serve")
    parser.add_argument("--artifact", default="", type=str,
                        help="exported artifact directory to serve (not ported)")
    parser.add_argument("--inpainting_mask", default="root_horizontal", type=str)
    parser.add_argument("--skip_steps", default=700, type=int)
    parser.add_argument("--timestep_respacing", default="ddim20", type=str)
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="model-parallel serving across cards (not ported)")
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", default=8500, type=int)
    parser.add_argument("--max_batch", default=8, type=int)
    parser.add_argument("--max_wait_ms", default=5.0, type=float)
    parser.add_argument("--max_queue", default=256, type=int,
                        help="bound the admission queue (0 = unbounded)")
    parser.add_argument("--style_strength", default=1.0, type=float,
                        help="scale of the learned style task vector (not ported)")
    parser.add_argument("--styles", default="", type=str,
                        help="extra named styles 'name=ckpt[,n2=ckpt2]' (not ported)")
    parser.add_argument("--deterministic", default=0, type=int,
                        help="serve every batch in the largest bucket shape")
    parser.add_argument("--max_body_mb", default=64.0, type=float)
    parser.add_argument("--request_timeout_s", default=120.0, type=float,
                        help="per-request deadline (504 on expiry; 0 = none)")
    parser.add_argument("--warmup", default=1, type=int,
                        help="run every batch bucket once before taking traffic")
    return parser


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    for flag, asks, what in REFUSED:
        if asks(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: {what} is not ported to motionstyle_torch")
    if not args.model_path:
        raise SystemExit("pass --model_path (a missing file serves a seeded "
                         "style encoder)")
    return args


def main(argv=None):
    args = parse_args(argv)
    from motionstyle_torch.serve.server import MotionServer

    engine, decode, handle = build_engine(args)
    if args.warmup:
        njoints, nframes = DATASET_DIMS[args.dataset]
        engine.warmup(decode({"content": np.zeros((nframes, njoints), np.float32)}))
    server = MotionServer(engine, host=args.host, port=args.port, decode=decode,
                          handle=handle, max_body_bytes=int(args.max_body_mb * (1 << 20)),
                          request_timeout_s=(args.request_timeout_s
                                             if args.request_timeout_s > 0 else None))
    import signal
    import threading

    # close() must run off the serve_forever thread (shutdown() waits for
    # that loop to exit) and must not be a daemon thread, or interpreter exit
    # would kill it mid-drain; join it after the loop returns
    closers = []

    def _graceful(signum, _frame):
        print(f"signal {signum}: draining and shutting down")
        t = threading.Thread(target=server.close)
        t.start()
        closers.append(t)

    signal.signal(signal.SIGTERM, _graceful)
    print(f"serving {args.dataset} style transfer on "
          f"http://{args.host}:{server.port} (POST /v1/sample)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    for t in closers:
        t.join()


if __name__ == "__main__":
    main()
