"""The port's data generators. The torch and JAX random streams differ, so
these check properties of the output: shapes, dtypes, the corruption count
and the label flips."""

import math

import numpy as np
import pytest
import torch

from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg

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


def test_perturb_logreg_without_corruption_and_structured():
    X, y, _ = gen_synthetic_logreg(torch.Generator().manual_seed(1), 50, d=4)
    X2, y2, _, out = perturb_logreg(torch.Generator().manual_seed(2), X, y, f_rate=0.0)
    assert torch.equal(X2, X) and torch.equal(y2, y) and out.numel() == 0
    with pytest.raises(NotImplementedError):
        perturb_logreg(torch.Generator().manual_seed(2), X, y, structured=True)


def test_generators_follow_the_generator_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    X, y, Z = gen_synthetic_logreg(gen, 10, d=2, dtype=torch.float64)
    assert X.device.type == "cpu" and Z.dtype == torch.float64
    assert np.isfinite(Z.numpy()).all()
