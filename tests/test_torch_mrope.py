"""The port's M-RoPE (qwen2-vl) against ``repro.nn.rotary``: ``apply_mrope``
in float32 within 1e-6 at qwen2-vl's head dim 128 with sections
(16, 24, 24) and at the SMOKE config's head dim 24 with (4, 4, 4), on
distinct temporal, height and width ids, so that a band reading another
section's id shows; and ``text_mrope_positions``, the text ids on all
three sections."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.nn import rotary as jrot

from repro_torch.nn import rotary as trot

B, S = 2, 40


def _ids(seed):
    """(3, B, S) int32 ids with t, h and w apart: a 16 x 16 grid after a
    text prefix, as a vision block would give, then random ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 300, (3, B, S)).astype(np.int32)
    grid = np.arange(16)
    ids[0, :, :16] = 7
    ids[1, :, :16] = grid
    ids[2, :, :16] = grid[::-1]
    return ids


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (24, (4, 4, 4))])
def test_apply_mrope_matches_the_reference(head_dim, sections):
    rng = np.random.default_rng(head_dim)
    q = rng.normal(size=(B, S, 4, head_dim)).astype(np.float32)
    k = rng.normal(size=(B, S, 2, head_dim)).astype(np.float32)
    ids = _ids(head_dim)
    jq, jk = jrot.apply_mrope(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(ids), sections=sections)
    tq, tk = trot.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(ids), sections=sections)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)
    # each band reads its own section: moving only the width ids moves
    # only the width bands (the last sections[2] of each half)
    moved = ids.copy()
    moved[2] += 5
    tq2, _ = trot.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(moved), sections=sections)
    half = head_dim // 2
    changed = (tq2 != tq).any(0).any(0).any(0).numpy()
    w0 = sections[0] + sections[1]
    want = np.zeros(head_dim, bool)
    want[w0:half] = want[half + w0:] = True
    np.testing.assert_array_equal(changed, want)


def test_text_positions_match_the_reference():
    j = np.asarray(jrot.text_mrope_positions(B, S, offset=3))
    t = trot.text_mrope_positions(B, S, offset=3)
    assert t.shape == (3, B, S) and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)


def test_text_positions_reduce_mrope_to_the_standard_rope():
    """On text ids every section holds the token index, so M-RoPE is the
    standard rope at the same theta."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(B, S, 4, 128)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, 2, 128)).astype(np.float32))
    pos = trot.text_mrope_positions(B, S)
    mq, mk = trot.apply_mrope(q, k, pos, theta=1e6)
    sq, sk = trot.apply_rope(q, k, pos[0], theta=1e6)
    torch.testing.assert_close(mq, sq, rtol=0, atol=0)
    torch.testing.assert_close(mk, sk, rtol=0, atol=0)


def test_sections_must_cover_half_the_head_dim():
    q = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="head_dim"):
        trot.apply_mrope(q, q, trot.text_mrope_positions(1, 2),
                         sections=(2, 2, 2))
