"""The port's evaluation modules held against the JAX package's on the
CPU: the batch stream, FID / IS, the pairwise tiles and precision /
recall, and the InceptionV3 extractor on the flax model's own weights."""
import os
import sys
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.evaluation import fid as jax_fid
from dddpm_tpu.evaluation import prec_recall as jax_pr
from dddpm_tpu.evaluation.inception import (
    FeatureExtractor as JaxExtractor,
    param_template_shapes as jax_template_shapes,
)
from dddpm_tpu_torch.evaluation import fid, prec_recall
from dddpm_tpu_torch.evaluation.evaluator import (
    Evaluator,
    flatten_batches,
    require_inception_optin,
)
from dddpm_tpu_torch.evaluation.inception import (
    FeatureExtractor,
    InceptionV3,
    from_flax_entries,
    load_params_npz,
    param_template_shapes,
    tf1_bilinear_matrix,
)
from dddpm_tpu_torch.evaluation.io import image_batch_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entries(params):
    """{flax path: numpy array} of a flax params tree."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(getattr(p, "key", str(p)) for p in ks): np.array(v)
            for ks, v in flat}


@pytest.fixture(scope="module")
def flax_fe():
    """The JAX package's extractor (PRNGKey(42) init), built once."""
    return JaxExtractor(batch_size=4)


@pytest.fixture(scope="module")
def port_fe(flax_fe):
    """The port's extractor on the CPU, with the flax extractor's weights."""
    fe = FeatureExtractor(batch_size=4, device="cpu")
    from_flax_entries(_entries(flax_fe.params), fe.model)
    return fe


# ------------------------------------------------------------------ io

def test_image_batch_stream_all_sources(tmp_path):
    rng = np.random.RandomState(11)
    arr5 = rng.randint(0, 255, (3, 4, 8, 8, 3)).astype(np.uint8)
    flat = arr5.reshape(-1, 8, 8, 3)
    npy, npz, npzc = (str(tmp_path / n) for n in ("a.npy", "a.npz", "c.npz"))
    np.save(npy, arr5)
    np.savez(npz, arr5)
    np.savez_compressed(npzc, flat)
    for src in (arr5, flat, npy, npz, npzc):
        batches = list(image_batch_stream(src, 5))
        assert [len(b) for b in batches] == [5, 5, 2]
        np.testing.assert_array_equal(np.concatenate(batches), flat)


def test_image_batch_stream_truncated_npz_raises(tmp_path):
    flat = np.random.RandomState(1).randint(0, 255, (6, 8, 8, 3)).astype(np.uint8)
    whole = str(tmp_path / "whole.npz")
    np.savez(whole, flat)
    with zipfile.ZipFile(whole) as zf:
        data = zf.read("arr_0.npy")
    cut = str(tmp_path / "cut.npz")
    with zipfile.ZipFile(cut, "w") as zf:   # a member missing its tail
        zf.writestr("arr_0.npy", data[:-100])
    with pytest.raises(IOError, match="truncated"):
        list(image_batch_stream(cut, 4))
    with pytest.raises(ValueError, match="4-D or 5-D"):
        list(image_batch_stream(np.zeros((3, 8, 8)), 2))


# ----------------------------------------------------------- FID and IS

def test_fid_statistics_and_is_equal_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(300, 24)
    b = rng.randn(250, 24) * 1.3 + 0.4
    sa, sa_j = (m.FIDStatistics.from_activations(a) for m in (fid, jax_fid))
    np.testing.assert_array_equal(sa.mu, sa_j.mu)
    np.testing.assert_array_equal(sa.sigma, sa_j.sigma)
    assert fid.compute_fid(a, b) == jax_fid.compute_fid(a, b)
    assert fid.compute_fid(a, a) == pytest.approx(0.0, abs=1e-8)
    soft = rng.dirichlet(np.ones(10), size=120)
    for split in (5000, 50):
        assert (fid.compute_inception_score(soft, split)
                == jax_fid.compute_inception_score(soft, split))


def test_fid_singular_covariance_equals_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(8, 32), rng.randn(8, 32)   # N < d: singular
    assert fid.compute_fid(a, b) == jax_fid.compute_fid(a, b)


# ------------------------------------------------------ precision / recall

def _clouds():
    rng = np.random.RandomState(4)
    real = rng.randn(300, 64).astype(np.float32)
    fake = (rng.randn(260, 64) * 1.1 + 0.25).astype(np.float32)
    return real, fake


def test_pairwise_tile_equals_jax():
    real, fake = _clouds()
    got = prec_recall.pairwise_sq_dists(torch.from_numpy(real),
                                        torch.from_numpy(fake)).numpy()
    want = np.asarray(jax_pr._pairwise_sq_dists(jnp.asarray(real),
                                                jnp.asarray(fake)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    exact = ((real[:, None].astype(np.float64) - fake[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-5)


@pytest.mark.parametrize("tiles", [2048, 64])
def test_radii_precision_recall_equal_jax(tiles):
    real, fake = _clouds()
    m = prec_recall.ManifoldEstimator(real, 3, tiles, tiles, device="cpu")
    m_j = jax_pr.ManifoldEstimator(real, 3, tiles, tiles)
    # the device merge keeps the values np.partition's host merge keeps
    d = prec_recall.pairwise_sq_dists(m.features, m.features).numpy()
    np.testing.assert_array_equal(m.radii, np.sort(d, axis=1)[:, 3])
    np.testing.assert_allclose(m.radii, m_j.radii, rtol=1e-5)
    np.testing.assert_array_equal(m.evaluate(fake), m_j.evaluate(fake))
    assert (prec_recall.compute_prec_recall(real, fake, device="cpu")
            == jax_pr.compute_prec_recall(real, fake))
    assert prec_recall.compute_prec_recall(real, real, device="cpu") == (1.0, 1.0)


# ------------------------------------------------------------- Inception

def test_flax_path_table_equals_jax():
    assert param_template_shapes() == jax_template_shapes()
    # the layout map: HWIO kernels, the (2048, 1008) Dense kernel
    model = InceptionV3()
    assert tuple(model.mixed_b[2].convs[0].conv.weight.shape) == (192, 768, 1, 1)
    assert param_template_shapes(model)[
        "params/MixedB_2/ConvBN_0/Conv_0/kernel"] == (1, 1, 768, 192)
    assert param_template_shapes(model)["params/Dense_0/kernel"] == (2048, 1008)


def test_tf1_resize_matrix_is_not_half_pixel():
    m = tf1_bilinear_matrix(4, 8)   # src = dst * 0.5, no half-pixel shift
    np.testing.assert_allclose(m[1], [0.5, 0.5, 0, 0])
    np.testing.assert_allclose(m[7], [0, 0, 0, 1])   # clamped at the edge


def test_inception_heads_equal_flax(flax_fe, port_fe):
    imgs = np.random.RandomState(7).randint(0, 255, (4, 24, 24, 3), np.uint8)
    want = flax_fe(imgs)
    got = port_fe(imgs)
    assert got["spatial"].shape == (4, 7 * 17 * 17)
    for k in ("pool3", "spatial", "softmax"):
        assert got[k].shape == want[k].shape, k
        tol = 1e-4 * float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= tol, k


def test_inception_grayscale_tail_and_paths(port_fe, tmp_path):
    rng = np.random.RandomState(8)
    gray = rng.randint(0, 255, (6, 12, 12, 1), np.uint8)
    out = port_fe(gray)   # batch 4: a tail of 2, run unpadded
    rgb = port_fe(np.repeat(gray, 3, axis=-1))
    for k in out:
        assert out[k].shape[0] == 6
        np.testing.assert_array_equal(out[k], rgb[k])
    npz = str(tmp_path / "s.npz")
    np.savez(npz, gray.astype(np.float32))
    from_path = port_fe(npz)
    for k in out:
        np.testing.assert_allclose(from_path[k], out[k], atol=1e-6)


def test_inception_golden_numbers(flax_fe):
    """tests/test_evaluation.py::test_inception_activation_golden's
    numbers, through the port, on scripts/gen_inception_golden.py's
    deterministic weights and input."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from gen_inception_golden import deterministic_params, golden_input

    fe = FeatureExtractor(batch_size=4, device="cpu")
    from_flax_entries(_entries(deterministic_params(flax_fe.params)), fe.model)
    out = fe(golden_input())
    assert out["pool3"].shape == (4, 2048)
    assert out["spatial"].shape == (4, 2023)
    assert out["softmax"].shape == (4, 1008)
    np.testing.assert_allclose(out["pool3"].mean(), 2.59155780e-02, rtol=1e-4)
    np.testing.assert_allclose(
        out["pool3"][0, :5],
        [0.0023822549264878035, 0.0352320596575737, 0.05151167884469032,
         0.043564535677433014, 0.015128325670957565], rtol=1e-3)
    np.testing.assert_allclose(out["spatial"].mean(), 1.84167381e-02, rtol=1e-4)
    np.testing.assert_allclose(
        out["spatial"][0, 3:6],
        [0.005008614156395197, 0.035317566245794296, 0.04901612177491188],
        rtol=1e-3)
    np.testing.assert_allclose(out["softmax"].mean(), 9.92063549e-04, rtol=1e-5)
    np.testing.assert_allclose(
        out["softmax"][0, :5],
        [0.0009896111441776156, 0.0009901128942146897, 0.0009915338596329093,
         0.0009932077955454588, 0.0009943470358848572], rtol=1e-3)


def test_npz_round_trip_and_strict_loader(flax_fe, port_fe, tmp_path):
    entries = _entries(flax_fe.params)
    full = str(tmp_path / "full.npz")
    np.savez(full, **entries)
    model = load_params_npz(full, InceptionV3())
    for (k, v), w in zip(model.state_dict().items(),
                         port_fe.model.state_dict().values()):
        assert torch.equal(v, w.cpu()), k

    missing = dict(entries)
    missing.pop("params/MixedC_1/ConvBN_8/Conv_0/bias")
    extra = dict(entries, **{"params/Nonexistent_0/kernel": np.zeros(3)})
    key = "params/MixedA_0/ConvBN_2/Conv_0/kernel"   # (5, 5, 48, 64)
    permuted = dict(entries, **{key: entries[key].transpose(3, 2, 0, 1)})
    for name, bad, match in (("missing", missing, "not in npz"),
                             ("extra", extra, "matched nothing"),
                             ("permuted", permuted, "shape mismatch")):
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **bad)
        with pytest.raises(ValueError, match=match):
            load_params_npz(path, InceptionV3())
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params_npz(str(tmp_path / "permuted.npz"), InceptionV3(),
                        allow_partial=True)
    # partial: what matches loads, the rest keeps its init
    part = InceptionV3()
    load_params_npz(str(tmp_path / "missing.npz"), part, allow_partial=True)
    np.testing.assert_array_equal(
        part.stem[0].conv.weight.detach().permute(2, 3, 1, 0).numpy(),
        entries["params/ConvBN_0/Conv_0/kernel"])

    fe = FeatureExtractor(full, batch_size=4, device="cpu")
    assert fe.has_real_weights
    with pytest.raises(FileNotFoundError):
        FeatureExtractor(str(tmp_path / "none.npz"), device="cpu")


def test_random_init_is_deterministic():
    a, b = FeatureExtractor(device="cpu"), FeatureExtractor(device="cpu")
    assert not a.has_real_weights
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_require_inception_optin(monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ", raising=False)
    with pytest.raises(SystemExit, match="refusing"):
        require_inception_optin(None, False, "prog")
    require_inception_optin(None, True, "prog")
    require_inception_optin("w.npz", False, "prog")
    monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", "w.npz")
    require_inception_optin(None, False, "prog")


class _FakeExtractor:
    """Small fixed activations of each image (the statistics' sqrtm at
    2048-d takes ~12 s on a CPU; the CLI test runs that one)."""

    has_real_weights = False
    device = torch.device("cpu")

    def __call__(self, images):
        flat = np.asarray(images, np.float64).reshape(len(images), -1)
        proj = np.random.RandomState(0).randn(flat.shape[1], 16) / 255.0
        feats = np.tanh(flat @ proj)
        soft = np.exp(feats[:, :10])
        return {"pool3": feats.astype(np.float32),
                "spatial": feats[:, :12].astype(np.float32),
                "softmax": (soft / soft.sum(1, keepdims=True)).astype(np.float32)}


def test_evaluator_equals_jax_on_the_same_activations():
    from dddpm_tpu.evaluation.evaluator import Evaluator as JaxEvaluator

    rng = np.random.RandomState(9)
    ref = rng.randint(0, 255, (3, 10, 8, 8, 3)).astype(np.float32)
    samples = rng.randint(0, 255, (25, 8, 8, 3)).astype(np.float32)
    assert flatten_batches(ref).shape == (30, 8, 8, 3)
    with pytest.raises(ValueError, match="image batch"):
        flatten_batches(np.zeros((4, 16, 16)))
    ev, ev_j = Evaluator.__new__(Evaluator), JaxEvaluator.__new__(JaxEvaluator)
    ev.extractor = ev_j.extractor = _FakeExtractor()
    for subset in (None, 20):
        got = ev.evaluate(ref, samples, prec_recall_subset=subset)
        want = ev_j.evaluate(ref, samples, prec_recall_subset=subset)
        assert set(got) == set(want) == {"is", "fid", "sfid", "precision",
                                         "recall", "inception_weights"}
        for k in ("is", "fid", "sfid", "precision", "recall"):
            assert np.isfinite(got[k]) and got[k] == pytest.approx(
                want[k], rel=1e-9, abs=1e-12), k
        assert got["inception_weights"] == "random-init"


def test_generator_batches_scale_an_eval_loader():
    from dddpm_tpu.evaluation.helpers import generator_batches as jax_gen
    from dddpm_tpu_torch.data.pipeline import get_dataloader
    from dddpm_tpu_torch.evaluation.helpers import generator_batches

    cfg = {"model": "ddpm", "dataset": "synthetic", "image_size": 8,
           "batch_size": 8, "rnd_flip": False}
    loader = get_dataloader(cfg, False, train_transform=False)
    got, want = next(generator_batches(loader)), next(jax_gen(loader))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 255 and got.max() > 1


def test_paths_match_jax_but_the_data_root():
    from dddpm_tpu.utils import paths as jax_paths
    from dddpm_tpu_torch.utils import paths

    for name in ("WORK_DIR", "SAMPLE_DIR", "SAMPLE_LATENT_DIR",
                 "CHECKPOINT_DIR", "REFERENCE_DIR", "LOGGING_DIR"):
        assert getattr(paths, name) == getattr(jax_paths, name), name
    assert paths.DATA_DIR == os.environ.get("DDDPM_DATA_DIR", "./data/")
