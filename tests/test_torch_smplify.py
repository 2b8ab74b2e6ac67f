"""The port's SMPLify chain (motionstyle_torch/post/{smplify,vis_utils,
motions2hik}.py, cli/fit_seq.py, cli/render_mesh.py) against the JAX
package's on the CPU, on random_smpl_model(n_verts=64) arrays that both
packages draw from the same RandomState.

Tolerances:
- the priors and the fitting losses at rtol 1e-5, their gradients at 1e-5 of
  each leaf's largest entry (float32 sums in another order);
- SMPLify3D's two-stage fit in float64 on both sides (the JAX fit under
  jax.enable_x64) at atol 1e-8: measured ~1e-10 after 10 + 20 Adam steps;
- in float32 (Joints2SMPL, fit_seq: the JAX wrapper takes float32 only) Adam
  divides by each gradient entry's own magnitude, so the two fits drift
  apart by rounding alone: measured up to 3.5e-3 on the pose and 1.9e-2 on
  the betas (their steps are lr = 0.01 a step, and near-zero gradient entries
  flip sign) after 20 + 5 steps; held at FIT32_ATOL / BETAS32_ATOL;
- joints2bvh and motions2hik from the same fitted pose: Euler angles in
  degrees at atol 1e-4 plus rtol 2e-5 (XLA's and torch's float32 atan2 and
  asin round differently, as tests/test_torch_post.py finds for BVH: measured
  1.6e-4 at -172.1 degrees, 8.4e-6 of the angle), the BVH hierarchy text
  equal;
- Npy2Obj and render_mesh's vertices at atol 1e-5.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.rotation2xyz import Rotation2xyz as JRotation2xyz
from motionstyle.models.smpl import SMPL as JSMPL, random_smpl_model as jrandom_smpl_model
from motionstyle.post import motions2hik as jhik, smplify as jsmplify, vis_utils as jvis
from motionstyle_torch.core import params
from motionstyle_torch.models.rotation2xyz import Rotation2xyz
from motionstyle_torch.models.smpl import SMPL, random_smpl_model
from motionstyle_torch.post import motions2hik, smplify, vis_utils
from motionstyle_torch.post.bvh import read_bvh
from tests.test_torch_models import one_torch_thread  # noqa: F401

PRIOR_RTOL = 1e-5
FIT64_ATOL = 1e-8
FIT32_ATOL, BETAS32_ATOL = 1e-2, 5e-2
EULER_ATOL, EULER_RTOL = 1e-4, 2e-5
VERTS_ATOL = 1e-5


@pytest.fixture(scope="module")
def smpls():
    """(JAX SMPL, port SMPL) on the same 64-vertex synthetic model."""
    return (JSMPL(jrandom_smpl_model(np.random.RandomState(0))),
            SMPL(random_smpl_model(np.random.RandomState(0))))


@pytest.fixture(scope="module")
def priors():
    return (jsmplify.MaxMixturePrior.synthetic(np.random.RandomState(1)),
            smplify.MaxMixturePrior.synthetic(np.random.RandomState(1)))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_angle_prior_matches_jax():
    pose = (np.random.RandomState(2).randn(3, 69) * 0.5).astype(np.float32)
    np.testing.assert_allclose(smplify.angle_prior(_t(pose)).numpy(),
                               np.asarray(jsmplify.angle_prior(jnp.asarray(pose))),
                               rtol=PRIOR_RTOL)


@pytest.mark.parametrize("make", ["synthetic", "from_arrays", "load"])
def test_mixture_prior_matches_jax(make, tmp_path):
    r = np.random.RandomState(3)
    if make == "synthetic":
        jp, tp = (m.MaxMixturePrior.synthetic(np.random.RandomState(4))
                  for m in (jsmplify, smplify))
    else:
        means = (r.randn(3, 69) * 0.1).astype(np.float32)
        a = r.randn(3, 69, 69).astype(np.float32) * 0.1
        covs = (a @ a.transpose(0, 2, 1) + np.eye(69) * 0.5).astype(np.float32)
        weights = np.array([0.5, 0.3, 0.2], np.float32)
        if make == "from_arrays":
            jp, tp = (m.MaxMixturePrior.from_arrays(means, covs, weights)
                      for m in (jsmplify, smplify))
        else:
            with open(tmp_path / "gmm_03.pkl", "wb") as f:
                pickle.dump({"means": means, "covars": covs, "weights": weights}, f)
            jp, tp = (m.MaxMixturePrior.load(str(tmp_path), 3) for m in (jsmplify, smplify))
    for k in ("means", "precisions", "nll_weights"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k))
    pose = (r.randn(5, 69) * 0.3).astype(np.float32)
    np.testing.assert_allclose(tp(_t(pose)).numpy(), np.asarray(jp(jnp.asarray(pose))),
                               rtol=PRIOR_RTOL)


def _loss_inputs(seed: int = 5, B: int = 5):
    r = np.random.RandomState(seed)
    f32 = lambda *s: (r.randn(*s) * 0.2).astype(np.float32)  # noqa: E731
    return {"orient": f32(B, 3), "body": f32(B, 69), "betas": f32(B, 10), "cam": f32(B, 3),
            "j3d": f32(B, 22, 3) * 2, "preserve": f32(B, 69)}


@pytest.mark.parametrize("loss", ["camera", "body"])
def test_fitting_losses_and_gradients_match_jax(loss, smpls, priors):
    """The stage losses through each package's SMPL joints: values at rtol
    1e-5, each leaf's gradient at 1e-5 of its largest entry."""
    jsmpl, tsmpl = smpls
    jfit = jsmplify.SMPLify3D(jsmpl, pose_prior=priors[0])
    tfit = smplify.SMPLify3D(tsmpl, pose_prior=priors[1])
    x = _loss_inputs()
    conf = np.linspace(0.5, 1.5, 22).astype(np.float32)
    leaves = ("orient", "body", "betas", "cam")

    def jloss(p):
        joints, _ = jfit._joints_of(jnp.concatenate([p["orient"], p["body"]], -1), p["betas"])
        if loss == "camera":
            return jsmplify.camera_fitting_loss_3d(joints, p["cam"], jnp.asarray(x["cam"]) * 0.5,
                                                   jnp.asarray(x["j3d"]), jfit._torso_smpl)
        return jsmplify.body_fitting_loss_3d(
            p["body"], jnp.asarray(x["preserve"]), p["betas"], joints[:, :22], p["cam"],
            jnp.asarray(x["j3d"]), priors[0], jnp.asarray(conf), joint_loss_weight=600.0,
            pose_preserve_weight=5.0)

    want, want_g = jax.jit(jax.value_and_grad(jloss))({k: jnp.asarray(x[k]) for k in leaves})
    p = {k: _t(x[k]).requires_grad_(True) for k in leaves}
    _, joints = tfit._joints_of(torch.cat([p["orient"], p["body"]], -1), p["betas"])
    if loss == "camera":
        got = smplify.camera_fitting_loss_3d(joints, p["cam"], _t(x["cam"]) * 0.5, _t(x["j3d"]),
                                             tfit._torso_smpl)
    else:
        got = smplify.body_fitting_loss_3d(
            p["body"], _t(x["preserve"]), p["betas"], joints[:, :22], p["cam"], _t(x["j3d"]),
            priors[1], _t(conf), joint_loss_weight=600.0, pose_preserve_weight=5.0)
    got.backward()
    assert abs(got.item() - float(want)) <= PRIOR_RTOL * abs(float(want))
    for k in leaves:
        g, w = p[k].grad.numpy(), np.asarray(want_g[k])
        assert np.abs(g - w).max() <= PRIOR_RTOL * np.abs(w).max() + 1e-12, k


@pytest.mark.parametrize("category, seq_ind", [("AMASS", 0), ("orig", 1)])
def test_smplify3d_matches_jax_in_float64(category, seq_ind, smpls, priors):
    """Both two-stage fits in float64 from the same start: pose, betas (fitted
    on a sequence's first clip only), camera, joints, vertices and the joint
    loss at atol 1e-8; an fp32 fit differs by rounding alone."""
    jsmpl, tsmpl = smpls
    r = np.random.RandomState(6)
    n = 22 if category == "AMASS" else 24
    j3d = r.randn(4, n, 3) * 0.3
    pose = r.randn(4, 72) * 0.1
    betas = r.randn(4, 10) * 0.1
    with jax.enable_x64(True):
        jfit = jsmplify.SMPLify3D(jsmpl, pose_prior=priors[0], num_iters=10,
                                  joints_category=category)
        want = jfit(jnp.asarray(pose), jnp.asarray(betas), jnp.zeros((4, 3)), jnp.asarray(j3d),
                    conf_3d=jnp.ones(n), seq_ind=seq_ind)
        want = {k: np.asarray(v) for k, v in want._asdict().items()}
    tfit = smplify.SMPLify3D(tsmpl, pose_prior=priors[1], num_iters=10,
                             joints_category=category)
    f64 = torch.float64
    got = tfit(_t(pose, f64), _t(betas, f64), torch.zeros(4, 3, dtype=f64), _t(j3d, f64),
               conf_3d=torch.ones(n, dtype=f64), seq_ind=seq_ind)
    assert want["pose"].dtype == np.float64 and got.pose.dtype == f64
    for k, w in want.items():
        np.testing.assert_allclose(getattr(got, k).numpy(), w, atol=FIT64_ATOL, rtol=1e-9,
                                   err_msg=k)
    if seq_ind:
        np.testing.assert_array_equal(got.betas.numpy(), betas)
    else:
        assert np.abs(got.betas.numpy() - betas).max() > 1e-3


@pytest.fixture(scope="module")
def fitters(smpls, priors):
    """(JAX, port) Joints2SMPL at 5 stage-2 steps with the same prior and
    the fix_foot boost; the port's on the CPU."""
    jj = jsmplify.Joints2SMPL(smpls[0], num_smplify_iters=5, fix_foot=True)
    tj = smplify.Joints2SMPL(smpls[1], num_smplify_iters=5, fix_foot=True, device="cpu")
    jj.smplify.pose_prior, tj.smplify.pose_prior = priors
    return jj, tj


def test_joints2smpl_matches_jax_with_its_warm_start(fitters):
    jj, tj = fitters
    joints = (np.random.RandomState(7).randn(4, 22, 3) * 0.3).astype(np.float32)
    init_j = init_t = None
    for call in range(2):  # the second call warm-starts from the first's fit
        want, init_j = jj.joint2smpl(joints, init_params=init_j)
        got, init_t = tj.joint2smpl(joints, init_params=init_t)
        assert got.shape == want.shape == (1, 25, 6, 4) and got.dtype == np.float32
        np.testing.assert_array_equal(got[0, -1, :3], joints[:, 0].T)  # the root row
        np.testing.assert_array_equal(got[0, -1, 3:], 0.0)
        np.testing.assert_allclose(got, want, atol=FIT32_ATOL, err_msg=f"call {call}")
        assert init_t.keys() == init_j.keys() == {"pose", "betas", "cam"}
        for k in init_t:
            atol = BETAS32_ATOL if k == "betas" else FIT32_ATOL
            assert init_t[k].shape == init_j[k].shape
            np.testing.assert_allclose(init_t[k], init_j[k], atol=atol, err_msg=f"{k} {call}")


def test_joints2smpl_runs_on_the_card_unless_asked(smpls):
    assert smplify.Joints2SMPL(smpls[1], num_smplify_iters=1).device == torch.device("cuda")


def _rot6d_motion(seed: int, T: int) -> np.ndarray:
    """A (1, 25, 6, T) pose tensor: 24 rot6d rows and the root row."""
    r = np.random.RandomState(seed)
    m = r.randn(1, 25, 6, T).astype(np.float32)
    m[0, -1, 3:] = 0.0
    return m


def test_joints2bvh_writes_the_jax_file(fitters, tmp_path, monkeypatch):
    """From the same fitted pose (joints2rotation pinned in both packages):
    the Butterworth-smoothed neck and head, the quaternions, offsets and root
    track. The hierarchy text is equal; the MOTION table's Euler degrees at
    1e-4."""
    motion = _rot6d_motion(8, 12)
    for mod in (jvis, vis_utils):
        monkeypatch.setattr(mod, "joints2rotation", lambda *a, **k: motion.copy())
    joints = np.zeros((12, 22, 3), np.float32)
    paths = [str(tmp_path / f"{n}.bvh") for n in ("jax", "port")]
    names = [f"j{i}" for i in range(22)]
    for mod, path, j2s in zip((jvis, vis_utils), paths, fitters):
        mod.joints2bvh(path, joints, params.smpl_real_offsets, params.t2m_kinematic_chain, j2s,
                       names=names)
    texts = [open(p).read() for p in paths]
    head = [t[:t.index("MOTION")] for t in texts]
    assert head[0] == head[1]
    want, got = (read_bvh(p) for p in paths)
    assert got.shape == want.shape == (12, 22)
    table = [np.array([[float(v) for v in line.split()] for line in t.split("\n")[
        t.split("\n").index("MOTION") + 3:] if line.strip()]) for t in texts]
    np.testing.assert_allclose(table[1], table[0], atol=EULER_ATOL, rtol=EULER_RTOL)


def test_joints2bvh_end_to_end(fitters, tmp_path):
    """The port's chain unpinned: the fit, then a BVH of the clip's frames."""
    joints = (np.random.RandomState(9).randn(4, 22, 3) * 0.2).astype(np.float32)
    path = str(tmp_path / "fit.bvh")
    vis_utils.joints2bvh(path, joints, params.smpl_real_offsets, params.t2m_kinematic_chain,
                         fitters[1], num_smplify_iters=5)
    anim = read_bvh(path)
    assert anim.shape == (4, 22) and np.isfinite(anim.quats).all()


class _PinnedFit:
    """A Joints2SMPL stand-in that returns one fixed pose tensor."""

    def __init__(self, motion):
        self.motion, self.device = motion, torch.device("cpu")

    def joint2smpl(self, joints, init_params=None, num_iters=None):
        return self.motion[..., :len(joints)].copy(), None


@pytest.mark.parametrize("payload", ["rot6d", "xyz"])
def test_motions2hik_matches_jax(payload):
    motions = _rot6d_motion(10, 5)[0][None].repeat(2, 0)  # (2 reps, 25, 6, 5)
    motions[1] = _rot6d_motion(11, 5)[0]
    fit = None
    if payload == "xyz":
        fit = _PinnedFit(_rot6d_motion(12, 5))
        motions = np.random.RandomState(13).randn(2, 22, 3, 5).astype(np.float32)
    want = jhik.motions2hik(motions, j2s=fit)
    got = motions2hik.motions2hik(motions, j2s=fit)
    assert got["joint_map"] == want["joint_map"] == motions2hik.HIK_JOINT_MAP
    assert np.asarray(got["thetas"]).shape == (2, 5, 24, 3)
    np.testing.assert_allclose(got["thetas"], want["thetas"], atol=EULER_ATOL, rtol=EULER_RTOL)
    np.testing.assert_array_equal(got["root_translation"], want["root_translation"])


@pytest.mark.parametrize("payload", ["rot6d", "xyz"])
def test_npy2obj_matches_jax(payload, smpls, tmp_path):
    T = 4
    motion = _rot6d_motion(14, T)
    fit = None
    if payload == "xyz":
        fit = _PinnedFit(motion)
        motion = np.random.RandomState(15).randn(2, 22, 3, T).astype(np.float32)
    npy = str(tmp_path / "results.npy")
    np.save(npy, {"motion": motion, "text": ["x", "y"], "lengths": np.asarray([T, T]),
                  "num_samples": 1, "num_repetitions": 2})
    rep = 1 if payload == "xyz" else 0
    want = jvis.Npy2Obj(npy, 0, rep, JRotation2xyz(smpls[0]), j2s=fit)
    got = vis_utils.Npy2Obj(npy, 0, rep, Rotation2xyz(smpls[1]), j2s=fit, device="cpu")
    assert got.vertices.shape == want.vertices.shape == (1, 64, 3, T)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=VERTS_ATOL)
    objs = [o.save_obj(str(tmp_path / f"{n}.obj"), 2, faces=np.array([[0, 1, 2]]))
            for n, o in (("jax", want), ("port", got))]
    lines = [open(p).read().splitlines() for p in objs]
    assert len(lines[0]) == len(lines[1]) == 65 and lines[1][-1] == lines[0][-1] == "f 1 2 3"
    for o, n in ((want, "jax"), (got, "port")):
        o.save_npy(str(tmp_path / f"{n}.npy"))
    dw, dg = (np.load(str(tmp_path / f"{n}.npy"), allow_pickle=True).item()
              for n in ("jax", "port"))
    assert dg.keys() == dw.keys() and dg["length"] == dw["length"] == T
    for k in ("motion", "thetas", "root_translation"):
        np.testing.assert_array_equal(dg[k], dw[k])
    np.testing.assert_allclose(dg["vertices"], dw["vertices"], atol=VERTS_ATOL)


def test_fit_seq_cli_matches_the_jax_cli(tmp_path):
    """cli/fit_seq.py in both packages, a directory of two files in chunks of
    3 frames (each chunk warm-started from the previous one's last frame),
    --num_smplify_iters 2, OBJ meshes: the same files, the fits within the
    float32 tolerances, each mesh the fitted pose's (the fitted betas and
    camera)."""
    from motionstyle.cli.fit_seq import main as jax_main
    from motionstyle_torch.cli.fit_seq import build_parser, main

    data = tmp_path / "data"
    data.mkdir()
    r = np.random.RandomState(0)
    np.save(data / "a.npy", (r.randn(6, 22, 3) * 0.3).astype(np.float32))
    np.save(data / "b.npy", (r.randn(3, 22, 3) * 0.3).astype(np.float32))
    argv = ["--data_folder", str(data), "--all", "--num_smplify_iters", "2", "--chunk", "3",
            "--save_obj", "1"]
    want = jax_main(argv + ["--save_folder", str(tmp_path / "jax")])
    got = main(argv + ["--save_folder", str(tmp_path / "port"), "--device", "cpu"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "a_smpl_params.npy", "b_smpl_params.npy"]
    for g, w in zip(got, want):
        dg, dw = (np.load(p, allow_pickle=True).item() for p in (g, w))
        assert dg.keys() == dw.keys() and dg["num_frames"] == dw["num_frames"]
        for k in ("pose", "cam", "motion"):
            assert dg[k].shape == dw[k].shape
            np.testing.assert_allclose(dg[k], dw[k], atol=FIT32_ATOL, err_msg=k)
        np.testing.assert_allclose(dg["betas"], dw["betas"], atol=BETAS32_ATOL)
        name = os.path.basename(g)[:-len("_smpl_params.npy")]
        objs = sorted(os.listdir(tmp_path / "port" / f"{name}_obj"))
        assert objs == sorted(os.listdir(tmp_path / "jax" / f"{name}_obj"))
        assert len(objs) == dg["num_frames"]
        verts = np.loadtxt(tmp_path / "port" / f"{name}_obj" / objs[-1], usecols=(1, 2, 3))
        jverts = np.loadtxt(tmp_path / "jax" / f"{name}_obj" / objs[-1], usecols=(1, 2, 3))
        assert verts.shape == jverts.shape == (64, 3)
        np.testing.assert_allclose(verts, jverts, atol=5 * FIT32_ATOL)
    assert build_parser().parse_args(["--data_folder", "x"]).device == "cuda"


def test_render_mesh_cli_matches_the_jax_cli(tmp_path):
    """cli/render_mesh.py on a rot6d results.npy (no fit on that path) in
    both packages: the same OBJ files with vertices at 1e-5 and the same
    _smpl_params.npy."""
    from motionstyle.cli.render_mesh import main as jax_main
    from motionstyle_torch.cli.render_mesh import build_parser, main

    outs = {}
    for name, run in (("jax", jax_main), ("port", main)):
        d = tmp_path / name
        d.mkdir()
        npy = str(d / "results.npy")
        np.save(npy, {"motion": np.concatenate([_rot6d_motion(16, 3)] * 2), "text": ["x", "y"],
                      "lengths": np.asarray([3, 2]), "num_samples": 2, "num_repetitions": 1})
        argv = ["--results", npy, "--sample_i", "1", "--num_smplify_iters", "2"]
        outs[name] = run(argv + (["--device", "cpu"] if name == "port" else []))
    objs = sorted(os.listdir(outs["port"]))
    assert objs == sorted(os.listdir(outs["jax"])) == ["frame000.obj", "frame001.obj"]
    for f in objs:
        np.testing.assert_allclose(np.loadtxt(os.path.join(outs["port"], f), usecols=(1, 2, 3)),
                                   np.loadtxt(os.path.join(outs["jax"], f), usecols=(1, 2, 3)),
                                   atol=VERTS_ATOL)
    dg, dw = (np.load(str(tmp_path / n / "sample01_rep00_smpl_params.npy"),
                      allow_pickle=True).item() for n in ("port", "jax"))
    assert dg.keys() == dw.keys() and dg["length"] == dw["length"] == 2
    np.testing.assert_allclose(dg["vertices"], dw["vertices"], atol=VERTS_ATOL)
    assert build_parser().parse_args([]).device == "cuda"
