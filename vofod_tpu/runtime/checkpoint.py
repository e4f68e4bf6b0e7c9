"""Sharding-preserving checkpoint/resume (Orbax) for detector state.

The reference has no map persistence at all (SURVEY.md §5 "Checkpoint /
resume: none for the voxel map").  The single-chip node closes that with a
host NPZ snapshot (runtime/node.py save_snapshot), but the grid-sharded
runtime (parallel/grid_step.py) exists precisely for operation areas whose
state should NOT be funneled through one host buffer.  This module wraps
Orbax — the standard JAX checkpointing library, already in the environment —
so sharded state saves per-shard straight from each device and restores
placed by an abstract target (shape/dtype/NamedSharding), never
materializing the full grid in host memory:

* ``save_state`` / ``restore_state`` — one-shot, works for the plain
  ``VoFODState`` of the single-chip node and for Z-sharded state on a
  ``Mesh`` alike (the state is a NamedTuple pytree either way).
* ``AsyncSaver`` — background save that overlaps subsequent detection
  steps (the serving-loop pattern: snapshot every N scans without stalling
  the 10 Hz stream).
* ``SnapshotManager`` — rolling keep-last-K checkpoints for long-running
  deployments (crash recovery: restore the newest good snapshot).

Restore targets: pass any state with the desired placement (a freshly
init'd state works — ``init_state`` or ``init_grid_sharded_state``); the
restored arrays adopt its shardings.
"""

from __future__ import annotations

import os

import jax


def _abstract_like(state):
    """Pytree of ShapeDtypeStruct+sharding directing a placed restore."""
    def one(x):
        x = jax.numpy.asarray(x)
        sharding = getattr(x, "sharding", None)
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding)

    return jax.tree.map(one, state)


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "checkpoint directories need the orbax-checkpoint package, "
            "which is not installed; save to a *.npz path instead"
        ) from e
    return ocp


def save_state(path: str, state, *, overwrite: bool = True) -> None:
    """Write ``state`` (any array pytree) as an Orbax checkpoint directory.

    Sharded arrays are written shard-by-shard from their devices (OCDBT) —
    no host gather of the full grid."""
    ocp = _ocp()
    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, state, force=overwrite)


def restore_state(path: str, like):
    """Restore a checkpoint onto the placement described by ``like``.

    ``like``: a state pytree whose shapes/dtypes/shardings are the restore
    target (e.g. ``init_state(cfg)`` on one chip, or
    ``init_grid_sharded_state(cfg, dyn, mesh)`` to land the shards straight
    on the mesh)."""
    ocp = _ocp()
    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path, target=_abstract_like(like))


class AsyncSaver:
    """Background checkpointing that does not stall the scan stream.

    ``save`` returns as soon as the device arrays are snapshotted; the
    serialization runs in Orbax's background thread while subsequent steps
    execute.  Call ``wait()`` (or close/exit the context) to join."""

    def __init__(self):
        ocp = _ocp()
        self._ckptr = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())

    def save(self, path: str, state, *, overwrite: bool = True) -> None:
        ocp = _ocp()
        self._ckptr.save(
            os.path.abspath(path),
            args=ocp.args.StandardSave(state),
            force=overwrite,
        )

    def wait(self) -> None:
        self._ckptr.wait_until_finished()

    def close(self) -> None:
        self.wait()
        self._ckptr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SnapshotManager:
    """Rolling keep-last-K snapshots keyed by step number.

    The crash-recovery loop for long-running serving: save every N scans,
    restore the latest on restart (``latest_step``/``restore``)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        ocp = _ocp()
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def save(self, step: int, state) -> None:
        ocp = _ocp()
        self._mgr.save(step, args=ocp.args.StandardSave(state))

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def restore(self, like, step: int | None = None):
        ocp = _ocp()
        step = self._mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no snapshots in manager directory")
        return self._mgr.restore(
            step, args=ocp.args.StandardRestore(_abstract_like(like))
        )

    def close(self) -> None:
        self._mgr.wait_until_finished()
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
