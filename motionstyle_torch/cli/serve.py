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
--styles serves extra named styles from the same model (a request picks one
with "style"); --style_strength scales every served style's task vector.
--model_path and each --styles entry take a finetuned encoder (model{step}.pt)
or a LoRA adapter (adapter{step}.pt), merged onto its run's base on the card.
--artifact serves an exported plan (cli/export_model.py) instead of a
checkpoint.

Run:  python -m motionstyle_torch.cli.serve --model_path save/.../model000000032.pt \\
        --dataset stylexia_posrot --fused 1 [--quant_int8 1] [--port 8500] \\
        [--styles angry=a/model000000024.pt,proud=p/model000000024.pt]
      python -m motionstyle_torch.cli.serve --artifact artifacts/angry_jump

Request:  POST /v1/sample
  {"content": [[...T x C...]], "text": "a person walks angrily", "seed": 7,
   "style": "angry"}
  (or "content_b64": base64 of little-endian float32 (T, C))
Response: {"motion": [[...C x 1 x T...]], "seed": 7}

Content longer than the model window is served long-form: the transfer runs
over chained windows (diffusion/longform.py), each window a normal engine
request that coalesces with concurrent single-clip traffic; POST /v1/stream
answers it window by window as NDJSON. The flags of the shared option groups
that a server does not run are refused (REFUSED), each naming its ROADMAP
item where one covers it.
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

# flag, when it asks for something the server does not run, what it needs
REFUSED = (
    ("model_parallel", lambda v: v > 1, "model-parallel serving (ROADMAP §1 item 11)"),
    # StyleDiffusion is trans_enc only in both packages
    # (motionstyle/cli/model_util.py:44-51); --emb_trans_dec has no effect on it
    ("arch", lambda v: v != "trans_enc",
     "another architecture (StyleDiffusion implements arch='trans_enc' only)"),
    # --profile traces a CLI's hot loop; a server runs until stopped, and the
    # JAX server parses the flag and ignores it
    ("profile", bool, "profiling, which needs a bounded hot loop that a server lacks"),
    ("fused_train", bool, "the training layer in a server, which runs no training forward"),
    ("fused_train_prng", bool,
     "the training layer's in-kernel dropout in a server, which runs no training forward"),
    ("fused_train_store", bool,
     "the training layer's stored probabilities in a server, which runs no training "
     "forward"),
)

DATASET_DIMS = {"stylexia_posrot": (181, 76), "bandai-1_posrot": (190, 196),
                "bandai-2_posrot": (190, 196), "humanml": (263, 196),
                "kit": (251, 196)}

LONGFORM_OVERLAP = 10  # frames each long-form window shares with the last


def build_sampler(args):
    """args -> (bundle, Sampler, item_shape, dump pick): the min-latency
    serving plan on args.device, with --style_strength applied; --fused and
    --quant_int8 reach the model's config through
    model_util.get_transfer_config. The exporter (cli/export_model.py)
    traces this same sampler."""
    from motionstyle_torch.cli import model_util
    from motionstyle_torch.diffusion.sampling import min_latency_plan
    from motionstyle_torch.parallel.inference import Sampler

    njoints, nframes = DATASET_DIMS[args.dataset]
    bundle, sched_ddim, _ = model_util.creat_serval_diffusion(
        args, args.timestep_respacing, device=args.device)
    model_util.apply_style_strength(bundle, args)
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
    """args -> (engine, decode, handle, stream): decode turns a JSON payload
    of exactly one window into an engine Request, handle answers a payload
    of one window or more, stream yields its answer window by window."""
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.serve.engine import Request, ServingEngine

    njoints, nframes = DATASET_DIMS[args.dataset]
    if args.artifact:
        from motionstyle_torch.serve.export import load_artifact

        art = load_artifact(args.artifact, args.device)
        if art.meta["dataset"] != args.dataset:
            raise SystemExit(f"artifact was exported for dataset "
                             f"{art.meta['dataset']}, serving {args.dataset}")
        sampler, pick = art.sampler, int(art.meta["dump_pick"])
        item_shape = sampler.item_shape
        encode_text = art.encode_text
        if encode_text is None:
            raise SystemExit("artifact has no text plan; re-export with "
                             "--text_plan 1 to serve captions from it")
        if art.meta["inpainting_mask"] != args.inpainting_mask:
            print(f"using the artifact's recorded inpainting_mask="
                  f"{art.meta['inpainting_mask']} (not --inpainting_mask "
                  f"{args.inpainting_mask})")
            args.inpainting_mask = art.meta["inpainting_mask"]
        buckets = tuple(art.meta["buckets"])
        args.max_batch = min(args.max_batch, buckets[-1])
        styles = art.styles
        if args.styles:
            raise SystemExit("--styles is an export-time choice for artifacts; "
                             "bake them in with export_model --styles (this "
                             f"artifact has {sorted(styles) or 'none'})")
    else:
        from motionstyle_torch.cli import model_util

        bundle, sampler, item_shape, pick = build_sampler(args)
        encode_text = lambda texts: bundle.encode_text(texts, args.dataset)  # noqa: E731
        buckets = (1, 2, 4, 8)
        styles = (model_util.load_named_styles(args, args.styles, bundle.cfg, bundle.device)
                  if args.styles else {})
    if styles:
        print(f"multi-style serving: {sorted(styles)} (one model, a style "
              f"encoder each)")
    engine = ServingEngine(sampler, item_shape, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, buckets=buckets,
                           deterministic=bool(args.deterministic),
                           max_queue=args.max_queue, dump_pick=pick, styles=styles)
    mask = np.asarray(get_inpainting_mask(
        args.inpainting_mask, (1,) + item_shape, dataset=args.dataset), np.float32)[0]

    from functools import lru_cache

    @lru_cache(maxsize=1024)
    def cached_encode_text(text: str) -> np.ndarray:
        """Per-caption memo of the frozen text tower, shared across styles
        (a style swaps only the style encoder)."""
        out = np.asarray(encode_text([text]), np.float32)[0]
        out.setflags(write=False)
        return out

    def _request_from(content: np.ndarray, payload: dict) -> Request:
        """(nframes, C) content + payload fields -> engine Request."""
        return Request({"enc_text": cached_encode_text(payload.get("text", ""))},
                       init_image=content.T[:, None, :], inpainting_mask=mask,
                       seed=payload.get("seed", 0), style=payload.get("style"))

    def decode(payload: dict) -> Request:
        content = _payload_content(payload, njoints)  # (T, C)
        if content.shape != (nframes, njoints):
            raise ValueError(f"content must be (frames={nframes}, channels={njoints}), "
                             f"got {content.shape}")
        return _request_from(content, payload)

    def _checked_content(payload: dict) -> np.ndarray:
        content = _payload_content(payload, njoints)  # (T, C)
        if content.ndim != 2 or content.shape[1] != njoints:
            raise ValueError(f"content must be (frames, channels={njoints}), "
                             f"got {content.shape}")
        if content.shape[0] < nframes:
            raise ValueError(f"content must be >= {nframes} frames long (got "
                             f"{content.shape[0]}); pad short clips client-side")
        return content

    def _long_stream(payload: dict, content: np.ndarray):
        """(offset, (C, 1, t) chunk) generator for content longer than the
        window: each window is an engine request riding the dynamic batcher,
        with the per-window seed longform.window_seed(seed, k)."""
        from motionstyle_torch.diffusion.longform import longform_stream, window_seed

        enc = cached_encode_text(payload.get("text", ""))
        seed = int(payload.get("seed", 0))
        window_idx = iter(range(1 << 20))

        def run_window(init, inp, _generator):
            k = next(window_idx)
            return engine.sample(Request(
                {"enc_text": enc}, init_image=np.asarray(init)[0],
                inpainting_mask=np.asarray(inp.mask)[0], seed=window_seed(seed, k),
                style=payload.get("style")))[None]

        long_content = content.T[None, :, None, :]  # (1, C, 1, T)
        # the mask at FULL length: a time-varying mask (prefix) differs per
        # frame, and broadcasting frame 0's column would pin the whole clip
        long_mask = np.asarray(get_inpainting_mask(
            args.inpainting_mask, long_content.shape, dataset=args.dataset), np.float32)
        for off, chunk in longform_stream(run_window, content.shape[0], nframes,
                                          overlap=LONGFORM_OVERLAP, content=long_content,
                                          content_mask=long_mask):
            yield off, chunk[0]

    def handle(payload: dict) -> np.ndarray:
        """Content of exactly `nframes` -> one batched request; longer
        content -> long-form transfer."""
        content = _checked_content(payload)
        if content.shape[0] == nframes:
            return engine.sample(_request_from(content, payload))
        return np.concatenate([c for _, c in _long_stream(payload, content)], axis=-1)

    def stream(payload: dict):
        """/v1/stream: yield {"offset", "motion"} per completed window;
        drained, the chunks equal handle()'s answer exactly (the same
        per-window seeds); exact-length content is one chunk. With request
        "encoding": "b64" chunks carry motion_b64/shape instead."""
        from motionstyle_torch.serve.server import encode_motion

        content = _checked_content(payload)
        if content.shape[0] == nframes:
            out = np.asarray(engine.sample(_request_from(content, payload)))
            yield {"offset": 0, **encode_motion(out, payload)}
            return
        for off, chunk in _long_stream(payload, content):
            yield {"offset": int(off), **encode_motion(chunk, payload)}

    return engine, decode, handle, stream


def build_parser() -> ArgumentParser:
    from motionstyle_torch.cli.parser_util import (
        add_base_options, add_diffusion_options, add_model_options)

    parser = ArgumentParser()
    add_base_options(parser)
    add_diffusion_options(parser)
    add_model_options(parser)
    parser.add_argument("--dataset", default="stylexia_posrot", type=str)
    parser.add_argument("--model_path", default="", type=str,
                        help="finetuned style checkpoint (full model{step}.pt or LoRA "
                             "adapter{step}.pt) to serve live (or pass --artifact)")
    parser.add_argument("--artifact", default="", type=str,
                        help="serve an exported artifact directory (cli/export_model.py): "
                             "no checkpoint or model rebuild on this host")
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
                        help="scale the learned style task vector (0 = no style, "
                             "1 = finetuned, >1 exaggerated)")
    parser.add_argument("--styles", default="", type=str,
                        help="extra named styles 'name=ckpt[,n2=ckpt2]' served from the "
                             "same model; requests pick one with 'style'")
    parser.add_argument("--deterministic", default=0, type=int,
                        help="serve every batch in the largest bucket shape")
    parser.add_argument("--max_body_mb", default=64.0, type=float)
    parser.add_argument("--request_timeout_s", default=120.0, type=float,
                        help="per-request deadline (504 on expiry; 0 = none)")
    parser.add_argument("--warmup", default=1, type=int,
                        help="run every batch bucket once before taking traffic")
    return parser


def check_supported(args) -> None:
    """Raise NotImplementedError for a flag the server does not run."""
    for flag, asks, what in REFUSED:
        if asks(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: {what} is not run by "
                "motionstyle_torch's server")


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    check_supported(args)
    if not args.model_path and not args.artifact:
        raise SystemExit("pass --model_path (live serving; a missing file serves a "
                         "seeded style encoder) or --artifact (an exported plan)")
    return args


def main(argv=None):
    args = parse_args(argv)
    from motionstyle_torch.serve.server import MotionServer

    engine, decode, handle, stream = build_engine(args)
    if args.warmup:
        njoints, nframes = DATASET_DIMS[args.dataset]
        engine.warmup(decode({"content": np.zeros((nframes, njoints), np.float32)}))
    server = MotionServer(engine, host=args.host, port=args.port, decode=decode,
                          handle=handle, stream=stream,
                          max_body_bytes=int(args.max_body_mb * (1 << 20)),
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
          f"http://{args.host}:{server.port} (POST /v1/sample, /v1/stream)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    for t in closers:
        t.join()


if __name__ == "__main__":
    main()
