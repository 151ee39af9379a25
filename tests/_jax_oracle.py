"""Pin the JAX reference, the oracle of the port's parity tests, to the CPU
at full fp32 matmul precision.

Where JAX also sees a GPU it takes it by default, and runs fp32 matmuls
there in TF32, which the port's 1e-5 / 1e-4 parity bars do not survive.
Each ``tests/test_torch_*.py`` that calls the reference uses

    @pytest.fixture(autouse=True, scope="module")
    def _oracle_on_cpu():
        yield from oracle_on_cpu()

so every reference call in it, module-scoped fixtures included, runs on the
CPU whether or not ``JAX_PLATFORMS=cpu`` is set.
"""


def oracle_on_cpu():
    try:
        import jax
    except ImportError:        # no oracle to pin; its callers skip
        yield
        return
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        yield
