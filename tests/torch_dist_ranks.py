"""Rank bodies of the port's multi-rank tests, and the spawner that runs them.

The tests of parallel/ and train/checkpoints.py start their ranks on the CPU
over gloo: spawn() starts `world` processes (the spawn start method, which
re-imports this module, so it imports neither JAX nor the JAX package),
each joins the group through a FileStore under the test's tmp directory
(never a TCP port: the test workers run side by side) with one torch
thread, runs one body over the payload and saves its result; the test
process reads the results and holds them against one rank and against the
JAX package's unsharded functions.

A body runs every case of its test file in one spawn: ranks start once per
world size per file.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT = 150  # seconds a spawn may take before the test fails


def spawn(world: int, body: str, tmp, payload: dict) -> list:
    """Run body(payload) on `world` ranks; returns each rank's result (a
    rank that failed returns {'error': its traceback})."""
    import time

    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, body, tmp, payload), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while any(p.is_alive() for p in ctx.processes):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{body} at world {world} took over {SPAWN_TIMEOUT} s")
        time.sleep(0.2)
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"{body}_rank{r}.pt")
        out.append(torch.load(path, weights_only=False) if os.path.exists(path) else
                   {"error": f"rank {r} exited with {ctx.processes[r].exitcode} and no result"})
    return out


def _entry(rank: int, world: int, body: str, tmp: str, payload: dict) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost")
    torch.set_num_threads(1)
    from motionstyle_torch.parallel import mesh

    store = os.path.join(tmp, f"{body}_store")
    mesh.init_distributed("cpu", init_method=f"file://{store}")
    path = os.path.join(tmp, f"{body}_rank{rank}.pt")
    try:
        out = globals()[body](payload)
    except Exception:  # noqa: BLE001 — the test reads the failure from the result
        torch.save({"error": f"rank {rank}: {traceback.format_exc()}"}, path)
        os._exit(1)  # the peers' collectives then fail instead of waiting
    torch.save(out, path)
    dist.barrier()
    dist.destroy_process_group()


def check(results: list) -> list:
    """The results, or every failed rank's traceback as the failure."""
    errors = [r["error"] for r in results if isinstance(r, dict) and "error" in r]
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# helpers shared by the bodies and the tests (no JAX here)
# ---------------------------------------------------------------------------

def port_model(state: dict, cfg_kw: dict):
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion

    model = StyleDiffusion(MDMConfig(**cfg_kw))
    model.load_state_dict(state)
    return model


def tensors(batch: dict) -> dict:
    return {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def grads_of(module) -> dict:
    """{name: whole gradient} of module's parameters that have one."""
    from motionstyle_torch.parallel import mesh

    return {n: mesh.gather_full(module, n, p.grad).clone() for n, p in module.named_parameters()
            if p.grad is not None}


def state_of(module) -> dict:
    from motionstyle_torch.parallel.mesh import full_tensor

    return {k: full_tensor(v).detach().clone() for k, v in module.state_dict().items()}


def counting(names=("all_reduce", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "broadcast", "send", "recv")):
    """Wrap torch.distributed's collectives with call counters; returns
    (counts, undo)."""
    counts = {n: 0 for n in names}
    saved = {n: getattr(dist, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            counts[n] += 1
            return saved[n](*a, **k)
        return f

    for n in names:
        setattr(dist, n, wrap(n))

    def undo():
        for n, f in saved.items():
            setattr(dist, n, f)

    return counts, undo


def finetune_trainer(payload: dict, save_dir: str, mesh=None, fsdp: bool = False, **kw):
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer

    model = port_model(payload["state"], payload["cfg"])
    cfg = FinetuneConfig(save_dir=save_dir, seed=payload.get("seed", 10), **kw)
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    return StyleFinetuneTrainer(cfg, model, sched, mesh=mesh, fsdp=fsdp)


def finetune_run(make_trainer, batches: list) -> list:
    """One run_step of a fresh trainer on each batch: its loss terms, the
    style encoder's whole gradients and its updated parameters. (A second
    step would compare Adam's sign of near-zero gradients, which rounding
    flips: tests/test_fsdp.py:117-121.)"""
    out = []
    for b in batches:
        tr = make_trainer()
        terms = tr.run_step(dict(b))
        if tr.lora is None:
            grads, params = grads_of(tr.model.style_encoder), state_of(tr.model.style_encoder)
        else:  # the factors' gradients and the merged weights
            grads = {f"{site}.{n}": f.grad.clone() for site, pair in tr.lora.items()
                     for n, f in pair.items()}
            params = {k: v.detach().clone() for k, v in tr.effective_weights().items()}
        out.append({"terms": terms, "grads": grads, "params": params})
    return out


def prior_trainer(payload: dict, save_dir: str, mesh=None, fsdp: bool = False, **kw):
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.train.pretrain import PretrainConfig, PriorTrainer

    model = port_model(payload["state"], payload["cfg"])
    cfg = PretrainConfig(save_dir=save_dir, **{**dict(num_steps=3, lr=1e-3, log_interval=0,
                                                      seed=3), **kw})
    return PriorTrainer(cfg, model, make_schedule("cosine", 50, device="cpu"), mesh=mesh,
                        fsdp=fsdp)


def prior_run(trainer, batches: list) -> dict:
    losses = [float(trainer.run_step(dict(b))) for b in batches]
    return {"losses": losses, "grads": grads_of(trainer.model.mdm)}


def sampler_inputs(payload: dict) -> dict:
    from motionstyle_torch.diffusion.ddpm import Inpainting

    s = payload["sampler"]
    return {"init_image": torch.from_numpy(s["content"]),
            "cond": {"enc_text": torch.from_numpy(s["enc_text"])},
            "inpainting": Inpainting(torch.from_numpy(s["mask"]),
                                     torch.from_numpy(s["content"]))}


def style_builder(model):
    return lambda params: (lambda x, t, c: params(x, t, c["enc_text"]))


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------

def mesh_cases(payload: dict) -> dict:
    """tests/test_torch_mesh.py at world 2."""
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.parallel import inference, mesh

    tmp = payload["tmp"]
    out = {}
    dp = mesh.make_mesh(2, device="cpu")
    tp = mesh.make_mesh(2, model_parallel=2, device="cpu")
    b = payload["batch"]
    out["shard_batch"] = {k: tuple(v.shape) for k, v in mesh.shard_batch(
        {"x": b["x_start"], "pair": b["content"]}, dp, replicate_indivisible=True).items()}
    try:
        mesh.shard_batch({"pair": b["content"]}, dp)
    except ValueError as e:
        out["indivisible"] = str(e)
    prng = dict(payload, cfg=dict(payload["cfg"], fused_train_prng=True))
    for name, m, p, kw in (("dp", dp, payload, {}), ("tp", tp, payload, {}),
                           ("prng", dp, prng, {}), ("lora", dp, payload, {"lora_rank": 4})):
        out[f"ft_{name}"] = finetune_run(
            lambda: finetune_trainer(p, os.path.join(tmp, name, str(dist.get_rank())), m,
                                     **payload["ft_kw"], **kw),
            [tensors(x) for x in payload["batches"]])
    # the gather with a gradient (the loss-aware sampler's history)
    r = dist.get_rank()
    x = torch.arange(6.0).reshape(3, 2).add(10 * r).requires_grad_(True)
    g = mesh.all_gather_batch(x, dp)
    (g * torch.arange(12.0).reshape(6, 2)).sum().backward()
    out["gathered"], out["gather_grad"] = g.detach(), x.grad
    # one step against the JAX trainer: dropout off, t and noise pinned
    j = payload["jax_step"]
    tr = finetune_trainer(j, os.path.join(tmp, "jax", str(dist.get_rank())), dp, **j["kw"])
    rows = mesh.data_rows(dp, j["t"].shape[0]) + (j["t"].shape[0],)
    batch = mesh.shard_batch(tensors(j["batch"]), dp, replicate_indivisible=True)
    terms = tr.train_step(batch, torch.from_numpy(j["t"]).long()[rows[0]:rows[1]], 0, rows,
                          int(tr.sched.timestep_map[int(j["t"][0])]),
                          noise_t2m=torch.from_numpy(j["noise_t2m"])[rows[0]:rows[1]],
                          noise=torch.from_numpy(j["noise"]))
    out["jax_step"] = {"loss": float(tr._data_mean({"l": terms["loss"]})["l"]),
                       "params": state_of(tr.model.style_encoder)}
    # sampling: data parallel, tensor parallel, the min-latency preset, the
    # Picard and forecast arms, data_parallel_sample
    model = port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    batch = sampler_inputs(payload)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    counts, undo = counting()
    try:
        out["dp_sample"] = inference.ShardedSampler(
            dp, sched, style_builder(model), model, method="ddim", skip_timesteps=14)(
            batch, gen())
        out["dp_counts"] = dict(counts)
        out["tp_collectives"] = mesh.COLLECTIVE_COUNTS["all_reduce"]
        out["tp_sample"] = inference.ShardedSampler(
            tp, sched, style_builder(model), model, method="ddim", skip_timesteps=14)(
            batch, gen())
        out["tp_collectives"] = mesh.COLLECTIVE_COUNTS["all_reduce"] - out["tp_collectives"]
    finally:
        undo()
    out["min_latency"] = inference.ShardedSampler.min_latency(
        dp, sched, style_builder(model), model)(batch, gen())
    out["window"] = inference.ShardedSampler(
        dp, sched, style_builder(model), model, parallel_window=4, method="ddim",
        skip_timesteps=14)(batch, gen())
    out["forecast"] = inference.ShardedSampler(
        dp, sched, style_builder(model), model, forecast_stride=2, method="ddim",
        skip_timesteps=14)(batch, gen())
    # the server's protocol: rank 0's engine over a Leader, rank 1 follows
    from motionstyle_torch.cli.serve import Leader, follow
    from motionstyle_torch.serve.engine import Request, ServingEngine

    served = inference.ShardedSampler.min_latency(tp, sched, style_builder(model), model)
    if dist.get_rank() == 0:
        leader = Leader(served, {})
        engine = ServingEngine(leader, tuple(batch["init_image"].shape[1:]), max_batch=2,
                               buckets=(2,))
        s = payload["sampler"]
        out["served"] = engine.sample(Request({"enc_text": s["enc_text"][0]},
                                              init_image=s["content"][0],
                                              inpainting_mask=s["mask"][0], seed=4))
        engine.close()
        leader.close()
    else:
        out["followed"] = follow(served, {})
    out["dp_helper"] = inference.data_parallel_sample(
        dp, sched, lambda x, t, c: model(x, t, c["enc_text"]), batch["cond"], gen(),
        tuple(batch["init_image"].shape), init_image=batch["init_image"],
        inpainting=batch["inpainting"], method="ddim", skip_timesteps=14)
    return out


def local_numel(tensors) -> int:
    """Elements this rank holds of tensors (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() for t in tensors)


def fsdp_cases(payload: dict) -> dict:
    """tests/test_torch_fsdp.py at world 2 or 4."""
    from motionstyle_torch.parallel import mesh

    tmp, world = payload["tmp"], dist.get_world_size()
    rank = str(dist.get_rank())
    out = {}
    m = mesh.make_mesh(world, device="cpu")
    batches = [tensors(b) for b in payload["prior_batches"]]
    counts, undo = counting()
    try:
        tr = prior_trainer(payload, os.path.join(tmp, "fsdp", rank), m, fsdp=True)
        out["prior_fsdp"] = prior_run(tr, batches[:1])
        out["fsdp_counts"] = dict(counts)
    finally:
        undo()
    out["prior_fsdp"]["losses"] += prior_run(tr, batches[1:])["losses"]
    params = [p for p, _ in tr.params]
    moments = [tr.opt.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")]
    out["local"] = {"params": local_numel(params), "moments": local_numel(moments),
                    "full": sum(p.numel() for p in params)}
    from torch.distributed.tensor import DTensor, Shard

    # one step against the JAX trainer's: dropout off, t, noise and the
    # masked condition pinned, each rank its rows
    j = payload["jax_step"]
    jt = prior_trainer(j, os.path.join(tmp, "jax", rank), m, fsdp=True, **j["kw"])
    B = j["t"].shape[0]
    a, b = mesh.data_rows(m, B)
    mine = lambda x: torch.from_numpy(np.asarray(x))[a:b]  # noqa: E731
    with mesh.batch_rows(a, b, B):
        loss, _ = jt.train_step({k: mine(v) for k, v in j["batch"].items()}, mine(j["t"]).long(),
                                mine(j["tw"]), noise=mine(j["noise"]), enc=mine(j["enc"]))
    out["jax_step"] = {"loss": float(jt._data_mean({"l": loss})["l"]),
                       "params": state_of(jt.model.mdm)}
    if world == 4:
        # FSDP composed with tensor parallelism: (2 data x 2 model)
        m2 = mesh.make_mesh(4, model_parallel=2, device="cpu")
        out["prior_fsdp_tp"] = prior_run(
            prior_trainer(payload, os.path.join(tmp, "fsdp_tp", rank), m2, fsdp=True), batches)
    lin1 = dict(tr.model.mdm.named_parameters())["seqTransEncoder.layers.0.linear1.weight"]
    out["linear1_placement"] = (isinstance(lin1, DTensor) and
                                lin1.placements == (Shard(mesh.fsdp_spec(
                                    "linear1.weight", tuple(lin1.shape), world).index("data")),))
    if world == 2:
        counts, undo = counting()
        try:
            dp = prior_trainer(payload, os.path.join(tmp, "dp", rank), m)
            out["prior_dp"] = prior_run(dp, batches[:1])
            out["dp_counts"] = dict(counts)
        finally:
            undo()
        fused = dict(payload, cfg=dict(payload["cfg"], fused_train=True))
        out["fused"] = {
            name: prior_run(prior_trainer(fused, os.path.join(tmp, name, rank), m, fsdp=f),
                            batches)["losses"]
            for name, f in (("fused_dp", False), ("fused_fsdp", True))}
        ft = payload["finetune"]
        tr = finetune_trainer(ft, os.path.join(tmp, "ft", rank), m, fsdp=True, **ft["kw"])
        out["finetune"] = [tr.run_step(dict(b)) for b in [tensors(b) for b in ft["batches"]]]
        # the kernels' guard: FSDP units below the encoder stack hand the
        # training path sharded weights
        from torch.distributed.fsdp import fully_shard

        model = port_model(fused["state"], fused["cfg"])
        for layer in model.style_encoder.layers:
            fully_shard(layer, mesh=m["data"])
        x = torch.randn(2, 5, model.cfg.latent_dim)
        try:
            model.style_encoder(x, fused_train=True, deterministic=False,
                                generator=torch.Generator().manual_seed(0))
        except TypeError as e:
            out["guard"] = str(e)
        try:  # the inference kernel's packed copies (packed_layers' cache)
            with torch.no_grad():
                model.style_encoder(x, use_fused=True)
        except TypeError as e:
            out["guard_inference"] = str(e)
    return out


def port_encoder(payload: dict):
    from motionstyle_torch.models.transformer import TransformerEncoder

    L, D, H, F = payload["dims"]
    enc = TransformerEncoder(L, D, H, F, dropout=0.1)
    enc.load_state_dict(payload["encoder"])
    return enc


def pipeline_cases(payload: dict) -> dict:
    """tests/test_torch_pipeline.py at world 2 (2 stages) or 4 (2 x 2)."""
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.parallel import inference, mesh, pipeline

    world, rank = dist.get_world_size(), dist.get_rank()
    m = mesh.make_mesh(world, pipeline_parallel=2, device="cpu")
    enc = port_encoder(payload)
    x, mask = (torch.from_numpy(payload[k]) for k in ("x", "mask"))
    a, b = mesh.data_rows(m, x.shape[0])
    xs, ms = x[a:b], mask[a:b]
    out = {"rows": (a, b)}
    for n_micro in (1, 2):
        out[f"fwd_micro{n_micro}"] = pipeline.pipeline_encoder(enc, xs, ms, m, n_micro)
    out["fwd_nomask"] = pipeline.pipeline_encoder(enc, xs, None, m, 2)
    if world == 4:
        return out
    # gradients of sum(out * w): the last stage's loss, the drain by hand
    xg = xs[:4].clone().requires_grad_(True)
    stages = pipeline.StagePipeline(enc, m, 2)
    y = stages.forward(xg, ms[:4])
    if stages.last:
        (y * torch.from_numpy(payload["w"])).sum().backward()
    stages.backward()
    out["grads"] = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
    out["x_grad"] = None if xg.grad is None else xg.grad.clone()
    out["stage"] = stages.stage
    # the pipelined sampler against one device
    model = port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    out["sample"] = inference.ShardedSampler(
        m, sched, pipeline.pipelined_style_model_fn_builder(model, m, 2), model,
        method="ddim", skip_timesteps=14)(sampler_inputs(payload), torch.Generator().manual_seed(5))
    # a pretrain step pipelined over 2 stages (dropout off), then its files
    tr = prior_trainer(payload["prior"], payload["tmp"] + "/pp", m, lr=1e-4)
    batch = tensors(payload["prior"]["batch"])
    out["prior_loss"] = float(tr.run_step(dict(batch)))
    tr.save_step()
    out["prior_saved"] = tr.cfg.save_dir
    return out


def sequence_cases(payload: dict) -> dict:
    """tests/test_torch_sequence.py at world 2 (2 frame shards) or 4 (2 x 2)."""
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.parallel import inference, mesh, sequence

    world = dist.get_world_size()
    m = mesh.make_mesh(world, sequence_parallel=2, device="cpu")
    enc = port_encoder(payload)
    x, mask = (torch.from_numpy(payload[k]) for k in ("x", "mask"))
    a, b = mesh.data_rows(m, x.shape[0])
    out = {"rows": (a, b)}
    with torch.no_grad():
        out["fwd_mask"] = sequence.sequence_parallel_encoder(enc, x[a:b], mask[a:b], m)
        out["fwd_nomask"] = sequence.sequence_parallel_encoder(enc, x[a:b], None, m)
    if world == 4:
        return out
    xg = x.clone().requires_grad_(True)
    y = sequence.sequence_parallel_encoder(enc, xg, mask, m)
    (y * torch.from_numpy(payload["w"])).mean().backward()
    sequence.sync_seq_grads(list(enc.parameters()), m)
    out["grads"] = {n: p.grad.clone() for n, p in enc.named_parameters()}
    out["x_grad"] = xg.grad.clone()
    model = port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    out["sample"] = inference.ShardedSampler(
        m, sched, sequence.seq_parallel_style_model_fn_builder(model, m), model,
        method="ddim", skip_timesteps=14)(sampler_inputs(payload), torch.Generator().manual_seed(5))
    return out


def checkpoint_cases(payload: dict) -> dict:
    """tests/test_torch_checkpoints.py at world 2: an FSDP finetune saves a
    DCP checkpoint; a DP trainer and an FSDP one restore it."""
    from motionstyle_torch.parallel import mesh

    tmp, rank = payload["tmp"], dist.get_rank()
    m = mesh.make_mesh(2, device="cpu")
    ft = payload["finetune"]
    save_dir = os.path.join(tmp, "fsdp")  # every rank writes its shards here
    tr = finetune_trainer(ft, save_dir, m, fsdp=True, orbax_checkpoints=True, save_interval=1,
                          **ft["kw"])
    tr.run_step(tensors(ft["batches"][0]))
    out = {"files": sorted(os.listdir(save_dir)), "params": state_of(tr.model.style_encoder),
           "opt_leaves": tr.optimizer_leaves()}
    for fsdp in (False, True):
        other = finetune_trainer(ft, os.path.join(tmp, f"restore{int(fsdp)}", str(rank)), m,
                                 fsdp=fsdp, **ft["kw"])
        step = other.load_sharded(os.path.join(save_dir, "dcp_000000001"))
        out[f"restored{int(fsdp)}"] = {"step": step, "params": state_of(other.model.style_encoder),
                                       "opt_leaves": other.optimizer_leaves()}
    return out
