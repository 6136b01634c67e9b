"""The port's embeddings (``eegsynth_torch/viz/embed.py``) against
scikit-learn, which the JAX package's figures call: StandardScaler, PCA
with the full SVD (within 1e-8 relative, signs included) and with the
default randomized solver (within 1e-4 of each component's scale, on
clustered data with a clear gap after the second singular value), t-SNE's
joint P on the same neighbour distances (within 1e-6), and t-SNE held to
properties (shape, finite, bit for bit on a second call, KL within 10 % of
scikit-learn's, trustworthiness within 0.02, 10-NN cluster agreement), not
to scikit-learn's coordinates."""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_array
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE
from sklearn.manifold import trustworthiness as sk_trustworthiness
from sklearn.manifold._t_sne import _joint_probabilities_nn
from sklearn.preprocessing import StandardScaler

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.viz import embed
from eegsynth_torch.viz.cluster import tsne_embed


def _clusters(n_per=50, dims=60, seed=0):
    """Three Gaussian clusters; labels."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, (3, dims))
    X = np.concatenate([c + rng.normal(size=(n_per, dims)) for c in centres])
    return X, np.repeat(np.arange(3), n_per)


@pytest.fixture(scope="module")
def tsne_pair():
    X, y = _clusters()
    ours = embed.tsne(X, perplexity=30.0)
    sk = TSNE(n_components=2, perplexity=30.0, init="pca", random_state=0).fit(X)
    return X, y, ours, sk


def test_standard_scale_matches_sklearn():
    X = np.random.default_rng(1).normal(2.0, 3.0, (120, 7))
    X[:, 4] = -1.5                                  # constant: scale 1
    got = embed.standard_scale(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, StandardScaler().fit_transform(X), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape,k", [((150, 60), 2), ((150, 60), 10), ((40, 300), 5),
                                     ((60, 60), 50)])
def test_pca_matches_full_svd(shape, k):
    X, _ = _clusters(shape[0] // 3, shape[1], seed=2)
    got = embed.pca(torch.as_tensor(X), k).numpy()
    want = PCA(n_components=k, svd_solver="full").fit_transform(X)
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want).max(axis=0) <= 1e-8 * scale).all()


def test_pca_matches_the_randomized_default():
    """The JAX figures' ``PCA(n_components=2)`` picks the randomized solver
    for a wide input; on clustered data with a gap after the second
    singular value it lands within 1e-4 of each component's scale."""
    X, _ = _clusters(200, 800, seed=3)
    pca = PCA(n_components=2, random_state=0)
    want = pca.fit_transform(X)
    assert pca._fit_svd_solver == "randomized"
    s = np.linalg.svd(X - X.mean(0), compute_uv=False)
    assert s[1] > 2 * s[2]
    got = embed.pca(torch.as_tensor(X), 2).numpy()
    assert (np.abs(got - want).max(axis=0) <= 1e-4 * np.abs(want).max(axis=0)).all()


def test_pca_past_the_rank_scores_zero():
    X = np.random.default_rng(4).normal(size=(2, 9))
    got = embed.pca(torch.as_tensor(X), 2).numpy()
    np.testing.assert_allclose(got, PCA(2, svd_solver="full").fit_transform(X), atol=1e-12)
    assert embed.pca(torch.as_tensor(X[:1]), 1).numpy().tolist() == [[0.0]]


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_joint_probabilities_match_sklearn(perplexity):
    X, _ = _clusters(seed=5)
    n, k = len(X), min(len(X) - 1, int(3 * perplexity + 1))
    d2, idx = embed.nearest_neighbors(torch.as_tensor(X), k)
    got = embed.joint_probabilities_nn(d2, idx, perplexity).numpy()
    dist = csr_array((d2.numpy().ravel(), idx.numpy().ravel(), np.arange(0, n * k + 1, k)),
                     shape=(n, n))
    want = _joint_probabilities_nn(dist, perplexity, 0).toarray()
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-12)


def test_tsne_shape_finite_and_deterministic(tsne_pair):
    X, _, ours, _ = tsne_pair
    Y = ours.embedding
    assert Y.shape == (len(X), 2) and torch.isfinite(Y).all()
    assert torch.equal(embed.tsne(X, perplexity=30.0).embedding, Y)
    assert ours.n_iter == 999


def test_tsne_kl_within_ten_percent_of_sklearn(tsne_pair):
    _, _, ours, sk = tsne_pair
    assert ours.kl_divergence <= 1.10 * sk.kl_divergence_


def test_tsne_trustworthiness_near_sklearn(tsne_pair):
    X, _, ours, sk = tsne_pair
    t_ours = sk_trustworthiness(X, ours.embedding.numpy(), n_neighbors=10)
    t_sk = sk_trustworthiness(X, sk.embedding_, n_neighbors=10)
    assert t_ours >= t_sk - 0.02
    assert abs(embed.trustworthiness(X, ours.embedding, 10) - t_ours) <= 1e-12


def test_tsne_keeps_the_clusters(tsne_pair):
    _, y, ours, _ = tsne_pair
    D = embed.sq_distances(ours.embedding)
    D.fill_diagonal_(float("inf"))
    nn = torch.topk(D, 10, dim=1, largest=False).indices.numpy()
    assert (y[nn] == y[:, None]).mean() >= 0.95


@pytest.mark.parametrize("n,perplexity", [(1, 30.0), (30, 30.0), (10, 12.5)])
def test_tsne_refuses_too_few_points(n, perplexity):
    X = np.random.default_rng(6).normal(size=(n, 4))
    with pytest.raises(embed.TooFewPoints, match="perplexity"):
        embed.tsne(X, perplexity=perplexity)
    assert issubclass(embed.TooFewPoints, ValueError)


def test_tsne_embed_clamps_tiny_inputs():
    rng = np.random.default_rng(7)
    Z = tsne_embed(rng.normal(size=(4, 10)), seed=0, perplexity=30.0)
    assert Z.shape == (4, 2) and np.isfinite(Z).all()
    Z1 = tsne_embed(rng.normal(size=(1, 10)), seed=0)
    assert Z1.shape == (1, 2) and np.all(Z1 == 0)


def test_winsorize_matches_numpy_quantiles():
    X = np.random.default_rng(8).standard_t(3, size=(999, 6))
    got = embed.winsorize(torch.as_tensor(X), 0.005, 0.995).numpy()
    want = np.clip(X, np.quantile(X, 0.005, axis=0), np.quantile(X, 0.995, axis=0))
    np.testing.assert_array_equal(got, want)
