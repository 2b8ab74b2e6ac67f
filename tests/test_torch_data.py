"""The port's data path against the JAX package's on the CPU (both numpy):
parse_opt_file (its bool quirk too), get_opt's table and opt_path,
Text2MotionDataset on a HumanML3D-layout corpus (the f/to caption tags, the
40 <= len < 200 filter, the unit-length crop on the `random` stream) and the
Bandai branch of StyleMotionDataset (its naming scheme, captions, window
slicing and the split file), their name_list, length_arr and items under one
random.seed: exact; t2m_collate and every loader's batches: exact; an
unknown name and an empty corpus raise.
"""
import os
import random
from dataclasses import asdict

import numpy as np
import pytest

from motionstyle.data import collate as jcollate
from motionstyle.data import datasets as jdatasets
from motionstyle_torch.data import collate, datasets
from tests.test_torch_models import one_torch_thread  # noqa: F401

NAMES = ("t2m", "humanml", "kit", "bandai-1_posrot", "bandai-2_posrot", "stylexia_posrot")


def _write_t2m(root, seed: int = 0, dim: int = 263) -> None:
    """A HumanML3D-layout corpus: new_joint_vecs, texts with caption#tokens#
    f#to lines (whole-clip and tagged sub-clip captions), train/test splits,
    Mean/Std; clip lengths on both sides of the 40 <= len < 200 filter."""
    r = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    lengths = {"000001": 196, "000002": 30, "000003": 120, "000004": 210, "000005": 64,
               "000006": 199, "000007": 150, "M000001": 88}
    for name, n in lengths.items():
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                r.randn(n, dim).astype(np.float32))
        lines = [f"a person walks forward#a/DET person/NOUN walk/VERB forward/ADV#0.0#0.0",
                 f"someone jumps {name}#someone/PRON jump/VERB#nan#nan"]
        if n >= 120:  # sub-clips: one long enough, one too short, one past the end
            lines += ["a person turns#a/DET person/NOUN turn/VERB#1.0#4.5",
                      "a brief wave#a/DET brief/ADJ wave/NOUN#0.5#1.5",
                      "then runs#then/ADV run/VERB#2.0#12.0"]
        if name == "000007":  # only tagged captions: no whole-clip entry
            lines = ["a person kicks#a/DET person/NOUN kick/VERB#0.2#3.0",
                     "malformed line without tags"]
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(list(lengths) + ["missing_clip"]) + "\n")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("000003\n000005\n")
    np.save(os.path.join(root, "Mean.npy"), (r.randn(dim) * 0.1).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), (np.abs(r.randn(dim)) + 0.5).astype(np.float32))


def _write_bandai(root, dataset: str = "bandai-2_posrot", split_file: bool = True) -> None:
    """A Bandai-layout corpus (dataset-N_{content}_{style}_{NNN}.npy) with
    clips shorter and longer than the 196-frame window, and its split file
    beside the data root (splits/{dataset}_test.txt)."""
    r = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    n = dataset[7]
    names = []
    for i, (content, style, frames) in enumerate([
            ("walk-turn-right", "feminine", 150), ("run", "angry", 420),
            ("walk", "old", 20), ("dash-left", "chimpira", 260), ("walk", "feminine", 196),
            ("raise-up-both-hands", "normal", 90)]):
        name = f"dataset-{n}_{content}_{style}_{i:03d}.npy"
        np.save(os.path.join(root, "new_joint_vecs", name),
                r.randn(frames, 190).astype(np.float32))
        names.append(name)
    np.save(os.path.join(root, "Mean.npy"), (r.randn(190) * 0.1).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), (np.abs(r.randn(190)) + 0.5).astype(np.float32))
    if split_file:
        os.makedirs(os.path.join(os.path.dirname(root), "splits"), exist_ok=True)
        with open(os.path.join(os.path.dirname(root), "splits", f"{dataset}_test.txt"),
                  "w") as f:
            f.write(f"{names[0]}\n{names[3]}\n")


@pytest.fixture(scope="module")
def t2m_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("t2m") / "HumanML3D")
    _write_t2m(root)
    return root


@pytest.fixture(scope="module")
def bandai_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bandai") / "bandai-2")
    _write_bandai(root)
    return root


def _same_dataset(got, want):
    assert got.name_list == want.name_list
    assert np.array_equal(got.length_arr, want.length_arr)
    assert got.data_dict.keys() == want.data_dict.keys()
    for k, d in want.data_dict.items():
        for field, v in d.items():
            g = got.data_dict[k][field]
            if isinstance(v, np.ndarray):
                assert np.array_equal(g, v), (k, field)
            else:
                assert g == v, (k, field)
    assert np.array_equal(got.mean, want.mean) and np.array_equal(got.std, want.std)


def _same_items(got, want, seed: int = 5):
    """Every item under one random.seed, the random stream consumed alike."""
    random.seed(seed)
    a = [got[i] for i in range(len(got))]
    random.seed(seed)
    b = [want[i] for i in range(len(want))]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(v, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v)
            else:
                assert u == v


def test_parse_opt_file_and_its_bool_quirk(tmp_path):
    p = tmp_path / "opt.txt"
    p.write_text("------------ Options -------------\nunit_length: 6\nlr: 0.0002\n"
                 "is_train: True\nuse_gpu: False\nname: Comp_v6\nmax_text_len: 25\n"
                 "dataset_name: t2m\n-------------- End ----------------\n")
    got, want = datasets.parse_opt_file(str(p)), jdatasets.parse_opt_file(str(p))
    assert got == want
    assert got["use_gpu"] is True  # bool("False"), as the reference's get_opt.py reads it
    assert got["unit_length"] == 6 and got["lr"] == 0.0002 and got["name"] == "Comp_v6"


@pytest.mark.parametrize("name", NAMES)
def test_get_opt_matches_jax(name, tmp_path):
    assert asdict(datasets.get_opt(name)) == asdict(jdatasets.get_opt(name))
    got = datasets.get_opt(name, "root")
    assert asdict(got) == asdict(jdatasets.get_opt(name, "root"))
    assert got.motion_dir == os.path.join("root", "new_joint_vecs")
    assert got.text_dir == os.path.join("root", "texts")
    p = tmp_path / "opt.txt"
    p.write_text("unit_length: 8\nmax_text_len: 30\nother: x\n")
    got = datasets.get_opt(name, "root", opt_path=str(p))
    assert asdict(got) == asdict(jdatasets.get_opt(name, "root", opt_path=str(p)))
    assert (got.unit_length, got.max_text_len) == (8, 30)
    assert datasets.get_opt(name, "root", opt_path=str(tmp_path / "absent.txt")).unit_length == 4


def test_get_opt_refuses_an_unknown_dataset():
    with pytest.raises(KeyError, match="not recognized"):
        datasets.get_opt("nope")


@pytest.mark.parametrize("split", ["train", "test"])
def test_text2motion_dataset_matches_jax(split, t2m_root):
    opt = datasets.get_opt("humanml", t2m_root)
    got = datasets.Text2MotionDataset(opt, split=split)
    want = jdatasets.Text2MotionDataset(jdatasets.get_opt("humanml", t2m_root), split=split)
    _same_dataset(got, want)
    assert len(got) > 0
    assert all(40 <= n < 200 for n in got.length_arr)
    if split == "train":  # tagged sub-clips and whole clips, the short and long ones gone
        assert any("_000003" in n for n in got.name_list) and "000002" not in got.name_list
        assert "000004" not in got.name_list and "000007" not in got.name_list
    _same_items(got, want)
    caption, motion, length, tokens, name = got[0]
    assert motion.shape == (196, 263) and length % opt.unit_length == 0


def test_text2motion_unit_length_and_kit_floor(t2m_root):
    """unit_length >= 10 crops 'single' only; kit's floor is 24 frames."""
    opt = datasets.get_opt("humanml", t2m_root)
    opt.unit_length = 10
    jopt = jdatasets.get_opt("humanml", t2m_root)
    jopt.unit_length = 10
    _same_items(datasets.Text2MotionDataset(opt), jdatasets.Text2MotionDataset(jopt), seed=9)
    kit = datasets.Text2MotionDataset(datasets.get_opt("kit", t2m_root))
    _same_dataset(kit, jdatasets.Text2MotionDataset(jdatasets.get_opt("kit", t2m_root)))
    assert min(kit.length_arr) >= 24


@pytest.mark.parametrize("dataset, split_file", [("bandai-2_posrot", True),
                                                 ("bandai-1_posrot", False)])
@pytest.mark.parametrize("split", ["train", "test"])
def test_bandai_dataset_matches_jax(dataset, split_file, split, tmp_path):
    root = str(tmp_path / dataset / "data")
    _write_bandai(root, dataset, split_file)
    opt = datasets.get_opt(dataset, root)
    got = datasets.StyleMotionDataset(opt, split=split, rng=np.random.RandomState(3))
    want = jdatasets.StyleMotionDataset(jdatasets.get_opt(dataset, root), split=split,
                                        rng=np.random.RandomState(3))
    _same_dataset(got, want)
    _same_items(got, want)
    if split == "train" and len(got):
        caption = got.data_dict[got.name_list[0]]["text"][0]["caption"]
        assert caption.startswith("A person ")
    if split == "test" and not split_file:
        assert len(got) == 0  # no split file: the reference's empty test split


def test_bandai_captions_and_windows(bandai_root):
    ds = datasets.StyleMotionDataset(datasets.get_opt("bandai-2_posrot", bandai_root))
    caps = {d["text"][0]["caption"] for d in ds.data_dict.values()}
    assert "A person runs angry" in caps and "A person raises up both hands normal" in caps
    # the 420-frame clip is cut into windows every 40 frames (offset 40)
    starts = sorted(int(n.rsplit("_", 1)[1]) for n in ds.name_list if "_run_" in n)
    assert starts[:3] == [0, 40, 80] and all(n.startswith("dataset-2_") for n in ds.name_list)
    assert min(ds.length_arr) >= 24  # the posrot names' floor


def test_t2m_collate_matches_jax(t2m_root):
    ds = datasets.Text2MotionDataset(datasets.get_opt("humanml", t2m_root))
    random.seed(2)
    batch = [ds[i] for i in range(3)]
    got, want = collate.t2m_collate(batch), jcollate.t2m_collate(batch)
    assert got[1]["y"].keys() == want[1]["y"].keys() == {"mask", "lengths", "text", "tokens",
                                                         "file_name"}
    assert got[0].dtype == np.float32 and got[0].shape == (3, 263, 1, 196)
    assert np.array_equal(got[0], want[0])
    for k, v in want[1]["y"].items():
        assert (np.array_equal(got[1]["y"][k], v) if isinstance(v, np.ndarray)
                else got[1]["y"][k] == v), k
    assert got[1]["y"]["mask"].shape == (3, 1, 1, 196)


@pytest.mark.parametrize("name", ["humanml", "bandai-2_posrot", "stylexia_posrot"])
def test_loaders_yield_the_jax_loaders_batches(name, t2m_root, bandai_root, tmp_path):
    if name == "stylexia_posrot":
        root = str(tmp_path / "xia")
        os.makedirs(os.path.join(root, "new_joint_vecs"))
        r = np.random.RandomState(0)
        for f in ("350angry_jumping.npy", "306neutral_running.npy", "100angry_walking.npy"):
            np.save(os.path.join(root, "new_joint_vecs", f),
                    r.randn(int(r.randint(30, 120)), 181).astype(np.float32))
        np.save(os.path.join(root, "Mean.npy"), np.zeros(181, np.float32))
        np.save(os.path.join(root, "Std.npy"), np.ones(181, np.float32))
    else:
        root = t2m_root if name == "humanml" else bandai_root
    got = collate.get_dataset_loader(name, 2, 196, split="train", data_root=root)
    want = jcollate.get_dataset_loader(name, 2, 196, split="train", data_root=root)
    assert len(got) == len(want) > 0
    random.seed(7)
    a = list(got)
    random.seed(7)
    b = list(want)
    for (m1, c1), (m2, c2) in zip(a, b):
        assert np.array_equal(m1, m2)
        for k, v in c2["y"].items():
            assert (np.array_equal(c1["y"][k], v) if isinstance(v, np.ndarray)
                    else c1["y"][k] == v), k
    ds = collate.get_dataset(name, 196, "test", root)
    assert type(ds).__name__ == type(jcollate.get_dataset(name, 196, "test", root)).__name__


def test_loader_unknown_name_and_empty_corpus(tmp_path):
    with pytest.raises(KeyError, match="not recognized"):
        collate.get_dataset("nope", 60)
    empty = str(tmp_path / "empty")
    os.makedirs(os.path.join(empty, "new_joint_vecs"))
    np.save(os.path.join(empty, "Mean.npy"), np.zeros(263, np.float32))
    np.save(os.path.join(empty, "Std.npy"), np.ones(263, np.float32))
    loader = collate.get_dataset_loader("humanml", 2, 196, data_root=empty)
    with pytest.raises(SystemExit, match="train.txt"):
        collate.require_batches(loader, "test")
