"""Unit tests for the core JAX ops against NumPy oracles."""

import jax.numpy as jnp
import numpy as np
import pytest

from vofod_tpu.geometry import GridSpec
from vofod_tpu.ops.binning import bin_points
from vofod_tpu.ops.compaction import masked_compact
from vofod_tpu.ops.components import SENTINEL, label_components, propagate_reach
from vofod_tpu.ops.morphology import (
    ball_offsets,
    ball_pool_max,
    ball_pool_min,
    ball_pool_min_naive,
    ball_pool_sum,
    dilate6,
)

from oracles import ball_offsets_np, ball_pool_min_np, euclidean_clusters_np


class TestBallPool:
    @pytest.mark.parametrize("radius", [1.0, 1.6, 2.0, 3.0])
    def test_offsets_match_oracle(self, radius):
        assert set(ball_offsets(radius)) == set(ball_offsets_np(radius))

    @pytest.mark.parametrize("radius", [1.0, 1.6, 3.0])
    def test_min_pool_matches_oracle(self, rng, radius):
        a = rng.integers(0, 1000, size=(9, 11, 13)).astype(np.int32)
        got = np.asarray(ball_pool_min(jnp.asarray(a), radius))
        want = ball_pool_min_np(a, radius)
        np.testing.assert_array_equal(got, want)

    def test_min_pool_matches_naive(self, rng):
        a = rng.normal(size=(8, 10, 12)).astype(np.float32)
        got = np.asarray(ball_pool_min(jnp.asarray(a), 3.0))
        want = np.asarray(ball_pool_min_naive(jnp.asarray(a), 3.0))
        np.testing.assert_array_equal(got, want)

    def test_max_pool_is_neg_min_pool(self, rng):
        a = rng.normal(size=(6, 7, 8)).astype(np.float32)
        got = np.asarray(ball_pool_max(jnp.asarray(a), 2.0))
        want = -np.asarray(ball_pool_min(jnp.asarray(-a), 2.0))
        np.testing.assert_allclose(got, want)

    def test_sum_pool_counts_ball(self):
        a = np.zeros((9, 9, 9), np.int32)
        a[4, 4, 4] = 1
        got = np.asarray(ball_pool_sum(jnp.asarray(a), 3.0))
        # every voxel within ball(3) of center sees exactly 1
        assert got.sum() == len(ball_offsets(3.0))
        assert got[4, 4, 4] == 1
        assert got[4, 4, 7] == 1  # distance 3
        assert got[4, 4, 8] == 0

    def test_dilate6(self):
        m = np.zeros((5, 5, 5), bool)
        m[2, 2, 2] = True
        d = np.asarray(dilate6(jnp.asarray(m)))
        assert d.sum() == 7
        assert d[2, 2, 3] and d[1, 2, 2]

    def test_dilate6_batched(self):
        m = np.zeros((2, 5, 5, 5), bool)
        m[0, 2, 2, 2] = True
        d = np.asarray(dilate6(jnp.asarray(m)))
        assert d[0].sum() == 7 and d[1].sum() == 0


class TestCompaction:
    def test_extracts_indices_in_order(self, rng):
        mask = rng.random((7, 9, 11)) < 0.05
        ids, valid, total = masked_compact(jnp.asarray(mask), 64)
        want = np.nonzero(mask.reshape(-1))[0]
        assert int(total) == len(want)
        n = min(len(want), 64)
        np.testing.assert_array_equal(np.asarray(ids)[:n], want[:n])
        assert np.asarray(valid).sum() == n

    def test_overflow_reported(self):
        mask = np.ones((4, 4, 64), bool)
        ids, valid, total = masked_compact(jnp.asarray(mask), 16)
        assert int(total) == 4 * 4 * 64
        assert np.asarray(valid).all()
        np.testing.assert_array_equal(np.asarray(ids), np.arange(16))

    def test_empty(self):
        mask = np.zeros((4, 5, 6), bool)
        ids, valid, total = masked_compact(jnp.asarray(mask), 8)
        assert int(total) == 0 and not np.asarray(valid).any()

    def test_fuzz_shapes_and_densities(self, rng):
        # block-boundary and capacity edge cases
        for n, p, cap in [
            (1024, 0.5, 600), (1025, 0.01, 16), (2048, 0.0, 8),
            (3000, 1.0, 64), (1, 1.0, 4), (65536, 0.001, 128),
        ]:
            mask = rng.random(n) < p
            ids, valid, total = masked_compact(jnp.asarray(mask), cap)
            want = np.nonzero(mask)[0]
            assert int(total) == len(want), (n, p, cap)
            k = min(len(want), cap)
            np.testing.assert_array_equal(np.asarray(ids)[:k], want[:k])
            assert int(np.asarray(valid).sum()) == k

    def test_large_sparse(self, rng):
        mask = np.zeros(300_000, bool)
        pick = rng.choice(300_000, 200, replace=False)
        mask[pick] = True
        ids, valid, total = masked_compact(jnp.asarray(mask), 256)
        np.testing.assert_array_equal(np.sort(pick), np.asarray(ids)[:200])


class TestComponents:
    def _random_occ(self, rng, p=0.08, shape=(10, 12, 14)):
        return rng.random(shape) < p

    def test_labels_match_ece_oracle(self, rng):
        occ = self._random_occ(rng)
        labels, conv = label_components(jnp.asarray(occ), 3.0, 64)
        assert bool(conv)
        got = np.asarray(labels)
        want, ncomp = euclidean_clusters_np(occ, 3.0)
        # same partition: map min-flat-id labels <-> oracle component ids
        assert (got[~occ] == int(SENTINEL)).all()
        seen = {}
        for z, y, x in zip(*np.nonzero(occ)):
            g, w = got[z, y, x], want[z, y, x]
            assert seen.setdefault(g, w) == w
        assert len(seen) == ncomp

    def test_reach_equals_component_membership(self, rng):
        occ = self._random_occ(rng, p=0.1)
        seed = self._random_occ(rng, p=0.01) & occ
        reached, conv = propagate_reach(jnp.asarray(occ), jnp.asarray(seed), 3.0, 64)
        assert bool(conv)
        got = np.asarray(reached)
        want_labels, _ = euclidean_clusters_np(occ, 3.0)
        seed_comps = set(want_labels[seed])
        want = np.isin(want_labels, list(seed_comps)) & occ
        np.testing.assert_array_equal(got, want)


class TestBinning:
    def test_multi_channel_matches_single(self, rng):
        from vofod_tpu.ops.binning import bin_points_multi
        import jax.numpy as jnp

        grid = GridSpec(origin=(0.0, 0.0, 0.0), shape=(8, 8, 8), voxel_size=0.5)
        pts = rng.uniform(-1, 5, size=(400, 3)).astype(np.float32)
        v1 = rng.random(400) < 0.7
        v2 = rng.random(400) < 0.4
        both = bin_points_multi(
            grid, jnp.asarray(pts),
            jnp.stack([jnp.asarray(v1), jnp.asarray(v2)], axis=-1).astype(jnp.int32),
        )
        np.testing.assert_array_equal(
            np.asarray(both[0]),
            np.asarray(bin_points(grid, jnp.asarray(pts), jnp.asarray(v1))),
        )
        np.testing.assert_array_equal(
            np.asarray(both[1]),
            np.asarray(bin_points(grid, jnp.asarray(pts), jnp.asarray(v2))),
        )

    def test_counts_match_histogram(self, rng):
        grid = GridSpec(origin=(0.0, 0.0, 0.0), shape=(8, 8, 8), voxel_size=0.5)
        pts = rng.uniform(-1, 5, size=(500, 3)).astype(np.float32)
        valid = rng.random(500) < 0.9
        counts = np.asarray(bin_points(grid, jnp.asarray(pts), jnp.asarray(valid)))
        want = np.zeros(grid.shape, np.int64)
        for p, v in zip(pts, valid):
            if not v:
                continue
            i = np.floor(p / 0.5).astype(int)
            if (i >= 0).all() and (i < 8).all():
                want[i[2], i[1], i[0]] += 1
        np.testing.assert_array_equal(counts, want)
        assert counts.sum() > 0
