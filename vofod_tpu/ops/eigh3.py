"""Closed-form symmetric 3x3 eigendecomposition (batched, branch-free).

Replaces ``jnp.linalg.eigh`` for the per-cluster PCA OBB (classify) — the
general eigensolver lowers to an iterative solver call per batch; the closed
form is ~100 flops per matrix and fully vectorized.

Method: eigenvalues via the trigonometric solution of the characteristic
cubic (Smith's algorithm); eigenvectors via cross products of (A - λI) rows,
picking the most independent pair (branch-free via argmax on row norms).
Degenerate (repeated-eigenvalue) cases fall back to an orthogonal complement
construction; inputs here always carry a tiny diagonal jitter.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def eigh3(A: Array) -> tuple[Array, Array]:
    """Eigen-decomposition of symmetric [..., 3, 3] matrices.

    Returns (evals [..., 3] ascending, evecs [..., 3, 3] with COLUMNS as the
    corresponding unit eigenvectors) — the same convention as jnp.linalg.eigh.
    """
    A = (A + jnp.swapaxes(A, -1, -2)) * 0.5
    q = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None] / 3.0
    B = A - q * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = detB / (2.0 * p**3 + 1e-30)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    e1 = q0 + 2.0 * p * jnp.cos(phi)  # largest
    e3 = q0 + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e2 = 3.0 * q0 - e1 - e3
    evals = jnp.stack([e3, e2, e1], axis=-1)  # ascending

    scale = jnp.maximum(jnp.abs(evals[..., 2]), 1e-20)

    def eigvec(lam):
        # rows of (A - lam I); eigenvector ⟂ two independent rows
        M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        n01 = jnp.sum(c01 * c01, axis=-1)
        n02 = jnp.sum(c02 * c02, axis=-1)
        n12 = jnp.sum(c12 * c12, axis=-1)
        best = jnp.argmax(jnp.stack([n01, n02, n12], axis=-1), axis=-1)
        cand = jnp.stack([c01, c02, c12], axis=-2)  # [..., 3, 3]
        v = jnp.take_along_axis(cand, best[..., None, None].repeat(3, -1), -2)[
            ..., 0, :
        ]
        n2 = jnp.sum(v * v, axis=-1, keepdims=True)
        ok = n2[..., 0] > (1e-12 * scale * scale) ** 2
        v = v / jnp.sqrt(jnp.maximum(n2, 1e-30))
        return v, ok

    ex = jnp.broadcast_to(
        jnp.array([1.0, 0.0, 0.0], A.dtype), evals[..., 0:1].shape[:-1] + (3,)
    )
    v3, ok3 = eigvec(evals[..., 0])
    v3 = jnp.where(ok3[..., None], v3, ex)  # degenerate: any axis works
    v1, _ = eigvec(evals[..., 2])
    # always orthogonalize the top vector against v3 (robust for repeated
    # eigenvalues), with a canonical fallback when the projection vanishes
    v1 = v1 - jnp.sum(v1 * v3, axis=-1, keepdims=True) * v3
    n1 = jnp.sum(v1 * v1, axis=-1, keepdims=True)
    u_idx = jnp.argmin(jnp.abs(v3), axis=-1)
    u = jnp.eye(3, dtype=A.dtype)[u_idx]
    u = u - jnp.sum(u * v3, axis=-1, keepdims=True) * v3
    u = u / jnp.sqrt(jnp.maximum(jnp.sum(u * u, axis=-1, keepdims=True), 1e-30))
    v1 = jnp.where(n1 > 1e-24, v1 / jnp.sqrt(jnp.maximum(n1, 1e-30)), u)
    v2 = jnp.cross(v3, v1)
    evecs = jnp.stack([v3, v2, v1], axis=-1)  # columns ascending
    return evals, evecs
