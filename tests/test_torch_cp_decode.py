"""The port's context-parallel decode (``parallel.cp_decode``) on 4 gloo
ranks, each holding a quarter of the cache's positions, held against
``repro``'s dense decode reference (``repro.nn.attention.
decode_attention``, one device, in this process) on the cases and shapes
of tests/test_cp_decode.py, at rtol/atol 2e-4.  The spawned ranks import
this module to find their function, so jax and ``repro`` are imported
inside the test."""
import numpy as np

from repro_torch.launch.mesh import make_mesh, run_ranks

B, HQ, HKV, L, D = 2, 8, 2, 64, 16
RANKS = 4
CASES = ((39, None), (39, 16), (20, None))


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, HQ, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, L, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, L, D)).astype(np.float32)
    kv_pos = np.where(np.arange(L) < 40, np.arange(L), -1).astype(np.int32)
    return q, k, v, kv_pos


def _rank(q, k, v, kv_pos, device):
    import torch
    from repro_torch.parallel.cp_decode import cp_decode_attention
    from repro_torch.parallel.sharding import Spec
    mesh = make_mesh((RANKS,), ("model",), device)
    seq = Spec((None, None, "model", None))
    loc = [seq.local(torch.from_numpy(t), mesh) for t in (k, v)]
    pos_l = Spec(("model",)).local(torch.from_numpy(kv_pos), mesh)
    return [cp_decode_attention(torch.from_numpy(q), *loc, pos_l, p, mesh,
                                window=w).numpy() for p, w in CASES]


def test_cp_decode_matches_dense_reference():
    import jax.numpy as jnp
    from repro.nn.attention import AttnSpec, decode_attention
    q, k, v, kv_pos = _inputs()
    outs = run_ranks(_rank, RANKS, (q, k, v, kv_pos))
    for r in range(1, RANKS):             # every rank ends with the same
        for a, b in zip(outs[0], outs[r]):
            np.testing.assert_array_equal(a, b)
    for (pos, window), got in zip(CASES, outs[0]):
        s = AttnSpec(d_model=HQ * D, n_heads=HQ, n_kv_heads=HKV,
                     head_dim=D, window=window)
        ref = decode_attention(jnp.asarray(q),
                               {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(kv_pos)},
                               jnp.int32(pos), s)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)
