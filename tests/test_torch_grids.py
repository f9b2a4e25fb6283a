"""PyTorch port vs the JAX package: the cell tensor and its grid lines, the
grid/cluster stage, the whole-matrix vector distances and the
vectordistance CLI (opticalflowclustering_tpu_torch.features.grid /
pipeline.bounce / cluster.matcher / cli.vectordistance ↔ the JAX modules
of the same path).

Integer outputs are held bitwise; the float32 distances at rtol 1e-6 on
float64 inputs (what the CLI reads from its CSVs); the CLI's stdout line
for line, its float32 cosine within rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cli import vectordistance as jvd
from opticalflowclustering_tpu.cluster import matcher as jm
from opticalflowclustering_tpu.features import grid as jg
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu_torch.cli import vectordistance as tvd
from opticalflowclustering_tpu_torch.cluster import matcher as tm
from opticalflowclustering_tpu_torch.features import grid as tg
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

# Frame sizes no multiple of either grid (a right and bottom remainder that
# no cell covers), and one that is.
SIZES = [(75, 131), (61, 257), (140, 250)]
GRIDS = [(14, 25), (10, 10)]


def _frames(h, w, lead=(2,), seed=0):
    return np.random.default_rng(seed).integers(0, 256, lead + (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("rows,cols", GRIDS)
@pytest.mark.parametrize("hw", SIZES)
def test_extract_cells_and_whiten_grid_lines_equal_jax(rows, cols, hw):
    """jg.extract_cells ↔ tg.extract_cells on [2, H, W, 3] and [2, 3, H, W,
    3] frames, and jg.whiten_grid_lines ↔ tg.whiten_grid_lines with
    own_rectangle True and False: array_equal; the input stays unwhitened."""
    grid_j, grid_t = jg.GridParams(rows, cols), tg.GridParams(rows, cols)
    for lead in ((2,), (2, 3)):
        x = _frames(*hw, lead)
        cells = tg.extract_cells(torch.from_numpy(x), grid_t)
        want = np.asarray(jg.extract_cells(jnp.asarray(x), grid_j))
        np.testing.assert_array_equal(cells.numpy(), want)
        ys, xs = grid_t.steps(*hw)
        assert cells.shape == lead + (rows * cols, ys, xs, 3)
        before = cells.clone()
        for own in (True, False):
            got = tg.whiten_grid_lines(cells, grid_t, own_rectangle=own).numpy()
            np.testing.assert_array_equal(got, np.asarray(jg.whiten_grid_lines(want, grid_j, own)))
        assert torch.equal(cells, before)


@pytest.mark.parametrize("rb_swap", [True, False])
@pytest.mark.parametrize("rows,cols", GRIDS)
def test_grid_cluster_stage_equals_jax(rows, cols, rb_swap):
    """jpl.grid_cluster_stage ↔ tpl.grid_cluster_stage on seeded 75×131
    frames with flat patches (so the k=1 centroids round at .5 too):
    centroids int32, hue uint8, rgb hue float32, all array_equal, on the
    device asked for."""
    x = _frames(75, 131, (3,), seed=rows + rb_swap)
    x[:, 10:40, 20:90] = (17, 200, 99)
    grid_j, grid_t = jg.GridParams(rows, cols), tg.GridParams(rows, cols)
    got = tpl.grid_cluster_stage(x, grid_t, rb_swap, device="cpu")
    want = jpl.grid_cluster_stage(jnp.asarray(x), grid_j, rb_swap)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].shape == (3, rows * cols)


def test_cosine_similarity_matrix_and_rowwise_euclidean_sum_equal_jax():
    """jm.cosine_similarity_matrix ↔ tm.cosine_similarity_matrix on [n,d] ×
    [m,d] float64 inputs (a zero row included), and
    jm.rowwise_euclidean_sum ↔ tm.rowwise_euclidean_sum on row counts that
    differ: rtol 1e-6, float32 results."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 180, (5, 7))
    b = rng.uniform(0, 180, (4, 7))
    b[2] = 0.0
    got = tm.cosine_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.cosine_similarity_matrix(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)
    assert float(got[:, 2].abs().max()) == 0.0
    for m in (3, 5):
        d = tm.rowwise_euclidean_sum(torch.from_numpy(a[:m]), torch.from_numpy(b))
        assert d.dtype == torch.float32
        np.testing.assert_allclose(float(d), float(jm.rowwise_euclidean_sum(jnp.asarray(a[:m]), jnp.asarray(b))),
                                   rtol=1e-6)


def _hue_csv(path, values):
    with open(path, "w") as f:
        f.writelines(f"{i + 2}.png,{v!r}\n" for i, v in enumerate(values))


@pytest.mark.parametrize("n1,n2", [(17, 30), (24, 24), (40, 9)])
def test_vectordistance_cli_prints_what_jax_prints(tmp_path, capsys, n1, n2):
    """The JAX vectordistance CLI ↔ the port's (--device cpu) on two hue
    CSVs (the reference's `<frame>.png,<hue>` rows; one file of float hues,
    one of integer hues): the same lines, the length warning included when
    the lengths differ; the Euclidean line byte-equal, and the printed
    float32 cosine within rtol 1e-6. Its last digits are not pinned: each
    side sums the float32 products and squares in its own order (XLA's CPU
    reductions are not sequential, pairwise or lane-wise), and the two
    results differ by up to a few ulp."""
    rng = np.random.default_rng(n1 * n2)
    f1, f2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    _hue_csv(f1, np.round(rng.uniform(0, 180, n1), 3).tolist())
    _hue_csv(f2, rng.integers(0, 180, n2).astype(float).tolist())
    jvd.main([f1, f2])
    want = capsys.readouterr().out.splitlines()
    tvd.main([f1, f2, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2 + (n1 != n2)
    assert got[:-2] == want[:-2] and got[-1] == want[-1]
    assert ("different lengths" in got[0]) == (n1 != n2)
    (label, value), (jlabel, jvalue) = (x.split(": ") for x in (got[-2], want[-2]))
    assert label == jlabel == "Cosine similarity"
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-6)


def test_vectordistance_cli_on_cuda_without_cuda_raises(tmp_path, monkeypatch):
    f = str(tmp_path / "a.csv")
    _hue_csv(f, [1.0, 2.0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tvd.main([f, f])
