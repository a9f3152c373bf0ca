"""The port's engine serving reduced deepseek-moe-16b and
qwen3-moe-235b-a22b against the JAX engine, on the CPU: the same weights
(the JAX params through ``params_from_jax``), float32, two slots, the
three ragged prompts of ``tests/test_torch_dense_variants.py`` (one grows
the pool a bucket), on the chunked (chunks of 8), whole-prompt, int8 and
``fused_decode=False`` paths.  Each call routes its own tokens as one
group, padding included, so the streams agree only if both engines route
the same token sets: they must be identical, and the pool must grow as
often.  ``prefix_cache=True`` on moe is held against JAX in
``tests/test_torch_moe.py`` (a file of its own keeps each under a
minute).
"""

import pytest

from test_torch_dense_variants import (_engines, _memory_tuner,  # noqa: F401
                                       _serve, _weights)
from test_torch_moe import ARCHS

#: engine path -> options (every path chunked at 8 but ``whole``)
PATHS = {"chunked": dict(prefill_chunk=8),
         "whole": dict(prefill_chunk=None),
         "int8": dict(prefill_chunk=8, kv_dtype="int8"),
         "gather": dict(prefill_chunk=8, fused_decode=False)}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, path):
    jeng, eng = _engines(_weights(arch), **PATHS[path])
    want, jrep = _serve(jeng)
    got, rep = _serve(eng)
    assert got == want
    assert rep.pool_growths == jrep.pool_growths >= 1

