"""The port's engine serving reduced qwen3-8b and nemotron-4-340b against
the JAX engine, on the CPU: the same weights (the JAX params through
``params_from_jax``), float32, two slots, three ragged prompts (one grows
the pool a bucket), on the chunked (chunks of 8), whole-prompt, int8 and
``fused_decode=False`` paths.  The token streams must be identical and
the pool must grow as often.  The models and the radix hit are in
``tests/test_torch_dense_variants.py``, whose weights and engines this
file shares.
"""

import pytest

from test_torch_dense_variants import (ARCHS, _engines,  # noqa: F401
                                       _memory_tuner, _serve, _weights)

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
