"""The sharded LLM program for the ssm and hybrid families on CPU ranks:
rwkv6-3b and zamba2-1.2b (REDUCED) with params laid out by ``param_specs``
over a ("data", "model") = (2, 2) mesh of 4 gloo ranks
(``launch.llm_ranks``, one group for both), their loss and gradients held
to the reference's unsharded ``loss_fn`` with the reference's weights and
to the port's unsharded one, within 1e-4 (relative Frobenius, the largest
leaf). A file apart from ``test_torch_sharded_llm.py`` so the two groups
of ranks can run on separate workers. ``-s`` prints the ``parity-gap``
lines.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import llm_ranks  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-1.2b")
MESH, B, S, BAR = (2, 2), 4, 16, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    yield from oracle_on_cpu()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {BAR:.0e})")
    assert value <= BAR, (what, value, BAR)


def _tree_gap(a, b) -> float:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return max(_rel(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def ranks():
    batch = TokenStream(512, S, B, seed=7).batch(0)
    cases = [dict(kind="grads", arch=a, remat=False, batch=batch,
                  params=jax.tree.map(np.asarray, jbb.init_params(
                      jconfigs.REDUCED[a], jax.random.PRNGKey(0),
                      jnp.float32)))
             for a in ARCHS]
    got = run_ranks(llm_ranks.sharded_cases, 4,
                    args=({"mesh": MESH, "cases": cases},), device="cpu",
                    timeout=600)
    for c, r in zip(cases, got[0]):
        print(f"sharded case {c['arch']}: {r['case_seconds']:.1f} s on rank 0")
    return dict(zip(ARCHS, zip(cases, got[0])))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(ranks, arch):
    case, got = ranks[arch]
    jc, tc = jconfigs.REDUCED[arch], tconfigs.REDUCED[arch]
    b = jax.tree.map(jnp.asarray, case["batch"])

    def jloss(p):
        return jbb.loss_fn(p, b, jc, use_pallas=False, remat=False,
                           compute_dtype=jnp.float32)[0]

    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                    case["params"]))
    lt, gt = llm_ranks.loss_and_grads(
        lm_params_from_numpy(case["params"], device="cpu"),
        {k: torch.as_tensor(v) for k, v in case["batch"].items()}, tc,
        remat=False)
    _gap(f"{arch} sharded loss vs reference", _rel(got["loss"], float(lj)))
    _gap(f"{arch} sharded loss vs port", _rel(got["loss"], float(lt)))
    _gap(f"{arch} sharded gradients vs reference",
         _tree_gap(got["grads"], jax.tree.map(np.asarray, gj)))
    _gap(f"{arch} sharded gradients vs port",
         _tree_gap(got["grads"], tree_map(lambda t: t.numpy(), gt)))
