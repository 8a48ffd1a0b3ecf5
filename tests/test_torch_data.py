"""The port's data generators. The torch and JAX random streams differ, so
these check properties of the output: shapes, dtypes, the corruption count
and the label flips."""

import math

import numpy as np
import pytest
import torch

from betacores_tpu_torch.data import (flip_labels, gen_synthetic_logreg,
                                     gen_synthetic_multiclass, perturb_logreg)

torch.set_num_threads(1)


def test_gen_synthetic_logreg_shapes_and_labels():
    X, y, Z = gen_synthetic_logreg(torch.Generator().manual_seed(0), 20000, d=5)
    assert X.shape == (20000, 5) and y.shape == (20000,) and Z.shape == (20000, 5)
    assert X.dtype == y.dtype == Z.dtype == torch.float32
    assert set(y.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(Z, y[:, None] * X)
    # X ~ N(1, I); with theta = 1 the label agrees with sign(X . theta) far more
    # often than chance
    assert abs(float(X.mean()) - 1.0) < 0.03 and abs(float(X.std()) - 1.0) < 0.03
    ps = torch.sigmoid(X.sum(dim=1))
    assert abs(float((y > 0).float().mean()) - float(ps.mean())) < 0.02


def test_gen_synthetic_logreg_is_seeded():
    a = gen_synthetic_logreg(torch.Generator().manual_seed(3), 100, d=3)[2]
    b = gen_synthetic_logreg(torch.Generator().manual_seed(3), 100, d=3)[2]
    c = gen_synthetic_logreg(torch.Generator().manual_seed(4), 100, d=3)[2]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("d", [4, 10])
def test_perturb_logreg_corrupts_f_rate_of_rows(d):
    N, f_rate = 5000, 0.1
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), N, d=d)
    X2, y2, Z2, out = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=f_rate)
    o = int(N * f_rate)
    assert X2.shape == X.shape and y2.shape == y.shape and torch.equal(Z2, y2[:, None] * X2)
    # inputs are not modified in place
    assert not torch.equal(X2, X)
    changed_x = (X2 != X).any(dim=1)
    flipped = y2 != y
    assert torch.equal(y2[flipped], -y[flipped])
    # o rows drawn with replacement for each of noise and flips
    n_x, n_y = int(changed_x.sum()), int(flipped.sum())
    assert o * math.exp(-f_rate) * 0.95 < n_x <= o and 0.8 * o < n_y <= o
    # exactly d // 2 columns carry noise, the others are untouched
    assert int((X2 != X).any(dim=0).sum()) == d // 2
    # the outlier index set is the sorted union of both corruptions
    expect = torch.nonzero(changed_x | flipped)[:, 0]
    assert torch.equal(out, torch.unique(out))
    assert set(expect.tolist()) <= set(out.tolist())
    assert len(out) <= 2 * o


def test_perturb_logreg_repeated_rows_keep_their_last_draw():
    """A row drawn several times ends with the noise of its last draw (what
    a sequential indexed write gives), so the data follows from the seed."""
    N, d, f_rate = 400, 6, 0.5
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), N, d=d)
    X2, _, _, _ = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=f_rate)
    g, o = torch.Generator().manual_seed(2), int(N * f_rate)
    idxx = torch.randint(0, N, (o,), generator=g)
    torch.randint(0, N, (o,), generator=g)
    cols = torch.randperm(d, generator=g)[:d // 2]
    noise = 5.0 * torch.randn((o, d // 2), generator=g, dtype=X.dtype)
    assert len(set(idxx.tolist())) < o            # some rows are drawn twice
    want = X.numpy().copy()
    for i, n in enumerate(idxx.tolist()):
        want[n, cols.numpy()] = noise[i].numpy()
    assert torch.equal(X2, torch.from_numpy(want))


def test_perturb_logreg_without_corruption_and_structured():
    """f_rate = 0 changes nothing; the structured branch (reference
    perturb.py:47-54) replaces int(N f_rate) rows, drawn with replacement,
    with draws of the adversarial logistic model: the replaced rows are
    exactly the outlier set, the others are untouched, and their labels
    follow theta = -1 (the share of +1 labels matches the model's mean
    probability, far from the clean data's)."""
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), 50, d=4)
    X2, y2, _, out = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=0.0)
    assert torch.equal(X2, X) and torch.equal(y2, y) and out.numel() == 0
    N, d, f_rate = 20000, 4, 0.1
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), N, d=d)
    X2, y2, Z2, out = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=f_rate,
                                     structured=True)
    assert torch.equal(Z2, y2[:, None] * X2) and not torch.equal(X2, X)
    changed = torch.nonzero((X2 != X).any(dim=1))[:, 0]
    assert torch.equal(changed, out) and torch.equal(out, torch.unique(out))
    o = int(N * f_rate)
    assert o * math.exp(-f_rate) * 0.95 < len(out) <= o
    Xo, yo = X2[out], y2[out]
    assert abs(float(Xo.mean()) - 0.1) < 0.03               # the adversary's mean_val
    p_adv = float(torch.sigmoid(-Xo.sum(dim=1)).mean())     # theta = -1
    assert abs(float((yo > 0).double().mean()) - p_adv) < 0.03
    assert abs(float((y > 0).double().mean()) - p_adv) > 0.3  # the clean labels differ


def test_perturb_logreg_structured_repeated_rows_keep_their_last_draw():
    """The structured branch, rebuilt from the same generator: a row drawn
    several times ends with its last draw, rows and labels alike."""
    N, d, f_rate = 400, 6, 0.5
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), N, d=d)
    X2, y2, _, _ = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=f_rate,
                                  structured=True)
    g, o = torch.Generator().manual_seed(2), int(N * f_rate)
    idxx = torch.randint(0, N, (o,), generator=g)
    Xa, ya, _ = gen_synthetic_logreg(g, o, d=d, mean_val=0.1, std_val=1.0, theta_val=-1.0)
    assert len(set(idxx.tolist())) < o            # some rows are drawn twice
    want_X, want_y = X.numpy().copy(), y.numpy().copy()
    for i, n in enumerate(idxx.tolist()):
        want_X[n], want_y[n] = Xa[i].numpy(), ya[i].numpy()
    assert torch.equal(X2, torch.from_numpy(want_X)) and torch.equal(y2, torch.from_numpy(want_y))


def test_generators_follow_the_generator_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    X, y, Z = gen_synthetic_logreg(gen, 10, d=2, dtype=torch.float64)
    assert X.device.type == "cpu" and Z.dtype == torch.float64
    assert np.isfinite(Z.numpy()).all()


def test_gen_synthetic_multiclass_shapes_and_labels():
    """Rows [X, y] with y a float class index drawn from the softmax model:
    each class's share matches the mean softmax probability under the
    generating parameters."""
    N, d, K = 40000, 5, 4
    X, y, Z = gen_synthetic_multiclass(torch.Generator().manual_seed(0), N, d=d,
                                       n_classes=K)
    assert X.shape == (N, d) and y.shape == (N,) and Z.shape == (N, d + 1)
    assert X.dtype == y.dtype == Z.dtype == torch.float32
    assert torch.equal(Z[:, :d], X) and torch.equal(Z[:, d], y)
    assert set(y.unique().tolist()) == set(range(K))
    assert abs(float(X.mean())) < 0.02 and abs(float(X.std()) - 1.0) < 0.02
    # the generating parameters are the first draw of the same stream
    Th = 2.0 * torch.randn((K, d), generator=torch.Generator().manual_seed(0))
    p = torch.softmax(X @ Th.T, dim=1)
    share = torch.bincount(y.long(), minlength=K).float() / N
    assert torch.allclose(share, p.mean(dim=0), atol=0.01)
    a = gen_synthetic_multiclass(torch.Generator().manual_seed(3), 50, d=3)[2]
    b = gen_synthetic_multiclass(torch.Generator().manual_seed(3), 50, d=3)[2]
    assert torch.equal(a, b)


@pytest.mark.parametrize("f_rate", [0.0, 0.2])
def test_flip_labels_moves_f_rate_of_rows_to_a_wrong_class(f_rate):
    N, K = 5000, 5
    _, _, Z = gen_synthetic_multiclass(torch.Generator().manual_seed(1), N, d=3, n_classes=K)
    Z0 = Z.clone()
    Zc, bad = flip_labels(torch.Generator().manual_seed(2), Z, K, f_rate)
    assert torch.equal(Z, Z0)                            # not modified in place
    assert bad.shape == (int(N * f_rate),) and len(set(bad.tolist())) == len(bad)
    changed = torch.nonzero(Zc[:, -1] != Z[:, -1])[:, 0]
    assert set(changed.tolist()) == set(bad.tolist())   # every flip is wrong
    assert torch.equal(Zc[:, :-1], Z[:, :-1])            # features untouched
    assert set(Zc[:, -1].unique().tolist()) <= set(range(K))
