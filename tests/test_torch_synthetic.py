"""The port's synthetic LM stream (``repro_torch.data.synthetic``): the
reference's affine-recurrence stream from a seeded numpy generator.  The
two packages' draws differ (numpy against ``jax.random``), so what is held
equal is the structure: shapes, types, label shift, determinism and the
recurrence itself where no noise flipped a token."""
import numpy as np

from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro_torch.data.synthetic import SyntheticLM, make_batch

import torch_threads  # noqa: F401


def test_batch_layout_matches_reference():
    ours = SyntheticLM(vocab=512, seq_len=16, batch=4, seed=1).batch_at(0)
    theirs = RefSyntheticLM(vocab=512, seq_len=16, batch=4, seed=1).batch_at(0)
    for k in ("tokens", "labels"):
        a, b = ours[k], np.asarray(theirs[k])
        assert a.shape == b.shape and a.dtype == b.dtype == np.int32
    t, lab = ours["tokens"], ours["labels"]
    assert ((t >= 0) & (t < 512)).all()
    np.testing.assert_array_equal(lab[:, :-1], t[:, 1:])
    assert (lab[:, -1] == -1).all()


def test_stream_is_seekable_and_seeded():
    data = SyntheticLM(vocab=97, seq_len=8, batch=3, seed=4)
    first = [b["tokens"] for _, b in zip(range(3), data)]
    np.testing.assert_array_equal(first[2], data.batch_at(2)["tokens"])
    assert not np.array_equal(first[0], first[1])
    other = SyntheticLM(vocab=97, seq_len=8, batch=3, seed=5).batch_at(0)
    assert not np.array_equal(first[0], other["tokens"])


def test_noise_free_stream_follows_an_affine_map():
    """With no noise every sequence is tok_{t+1} = (a·tok_t + b) mod V for
    one odd a, and the sequences share a small pool of maps."""
    v = 101
    out = make_batch(np.random.default_rng(0), v, 16, 12, noise=0.0,
                     n_maps=2)
    maps = set()
    for seq in out["tokens"].astype(np.int64):
        fits = [(a, b) for a in range(3, v + 1, 2) for b in range(v)
                if all((a * seq[i] + b) % v == seq[i + 1]
                       for i in range(len(seq) - 1))]
        assert fits
        maps.add(fits[0])
    assert len(maps) <= 2
