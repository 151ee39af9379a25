"""The port's checkpoint store (``repro_torch.checkpoint.store``): the
reference's tests of ``repro.checkpoint.store`` (tests/test_substrate.py)
on the port, nested trees of fp32 / int32 / bf16 leaves, and files that
either package writes and the other reads, equal byte for byte.

Two saves of one tree differ only in the zip entries' timestamps, so the
byte-for-byte comparison pins ``time.time`` while both packages write.
"""
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _mixed_tree():
    """(port tree, reference tree) of one nested dict / list / tuple of
    fp32, int32 and bf16 leaves, dict keys out of sorted order."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (4,)).astype(np.int32)
    b16 = rng.standard_normal((2, 7)).astype(np.float32)
    port = {"z": torch.from_numpy(f32),
            "a": [torch.from_numpy(i32),
                  (torch.from_numpy(b16).to(torch.bfloat16),
                   {"k": torch.tensor(2.5)})]}
    ref = {"z": jnp.asarray(f32),
           "a": [jnp.asarray(i32),
                 (jnp.asarray(b16).astype(jnp.bfloat16),
                  {"k": jnp.asarray(2.5, jnp.float32)})]}
    return port, ref


def test_checkpoint_roundtrip(tmp_path):
    cfg = REDUCED["llama3.2-1b"]
    params = bb.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    path = str(tmp_path / "ck.npz")
    store.save(path, params, {"arch": cfg.name})
    restored = store.load(path, params)
    assert list(restored) == list(params)
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert store.load_metadata(path)["arch"] == cfg.name


def test_checkpoint_nested_tree_and_dtypes(tmp_path):
    tree, _ = _mixed_tree()
    path = str(tmp_path / "ck.npz")
    store.save(path, tree)
    got = store.load(path, tree)
    assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert store.load_metadata(path) == {}
    # the keys, and the bf16 entry as the reference writes it
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == ["__meta__.npy", "a/#0.npy", "a/#1/#0.npy",
                                 "a/#1/#1/k.npy", "z.npy"]
        assert b"'descr': '<V2'" in zf.read("a/#1/#0.npy")[:128]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    store.save(path, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        store.load(path, {"w": torch.ones(3, 3)})


def test_checkpoint_missing_key_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    store.save(path, {"w": torch.ones(2)})
    with pytest.raises(KeyError, match="b/#0"):
        store.load(path, {"w": torch.ones(2), "b": [torch.ones(1)]})


def test_checkpoint_concurrent_saves_same_path(tmp_path):
    """Concurrent save() calls to ONE path: each writer owns a unique
    mkstemp .npz temporary, so the surviving checkpoint is one writer's
    intact tree and no temporary is left behind."""
    path = str(tmp_path / "ck.npz")
    trees = [{"w": torch.full((64, 64), float(i))} for i in range(8)]
    errs = []

    def save(i):
        try:
            store.save(path, trees[i], {"i": i})
        except Exception as e:       # pragma: no cover - the assert reports
            errs.append(e)

    threads = [threading.Thread(target=save, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    v = store.load(path, trees[0])["w"]
    i = store.load_metadata(path)["i"]
    assert torch.equal(v, trees[i]["w"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]


def test_checkpoint_files_equal_the_reference_byte_for_byte(tmp_path,
                                                            monkeypatch):
    port, ref = _mixed_tree()
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    store.save(tp, port, {"arch": "x", "steps": 3})
    jstore.save(jp, ref, {"arch": "x", "steps": 3})
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()


def test_checkpoint_files_read_across_packages(tmp_path):
    """The port reads the reference's file (a bf16 leaf back as
    torch.bfloat16) and the reference reads the port's (its raw bytes,
    as it reads its own)."""
    port, ref = _mixed_tree()
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    store.save(tp, port)
    jstore.save(jp, ref)
    got = store.load(jp, port)
    for a, b in zip(tree_leaves(port), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    own, other = jstore.load(jp, ref), jstore.load(tp, ref)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(other)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert jstore.load_metadata(tp) == store.load_metadata(jp) == {}


@pytest.mark.cuda
def test_checkpoint_loads_onto_the_templates_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree, _ = _mixed_tree()
    path = str(tmp_path / "ck.npz")
    store.save(path, tree)
    on_card = {"z": tree["z"].cuda(), "a": tree["a"]}
    got = store.load(path, on_card)
    assert got["z"].device.type == "cuda"
    assert all(t.device.type == "cpu" for t in tree_leaves(got["a"]))
    assert torch.equal(got["z"].cpu(), tree["z"])
