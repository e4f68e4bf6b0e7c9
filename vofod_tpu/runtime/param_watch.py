"""Live parameter tuning from a watched YAML file.

The reference exposes every score/threshold/gate through dynamic_reconfigure
(config/dynamic_reconfigure/DetectionParams.cfg:16-44) and reads the current
values EVERY scan (m_drmgr_ptr->config.*, vofod_nodelet.cpp:75,155) — an
operator retunes the running detector from the rqt GUI.  The framework's
equivalent knob is ``VoFOD.update_params`` (traced DynParams — no
recompile); this module gives that knob the same operator workflow for
offline/serving runs: edit the detection_params YAML while the run is live,
and the watcher applies the delta before the next scan.

Used by ``tools/detect.py --watch-params`` and usable from any serving loop
(poll() is cheap: one stat per scan until the file changes).
"""

from __future__ import annotations

import dataclasses
import logging
import os

from vofod_tpu.config import DynParams

_log = logging.getLogger("vofod_tpu.params")

# the two stencil-shaping radii are static unless cfg.dynamic_radii
# (config.py VoFODConfig.dynamic_radii; VERDICT round-2 item 4)
_RADII = ("ground_points_max_distance", "sepclusters_max_bg_distance")


class ParamWatcher:
    """Polls a detection_params-format YAML and applies changed DynParams.

    A malformed edit never kills the run: parse errors are logged and the
    previous parameters stay in force (the operator fixes the file and the
    next poll picks it up)."""

    def __init__(self, node, path: str):
        self.node = node
        self.path = path
        self._mtime: float | None = None
        self.n_applied = 0  # total updates applied (observability/tests)

    def poll(self) -> dict | None:
        """Apply the file's dynamic params if it changed since last poll.

        Returns the dict of changed fields (possibly empty if the file
        changed but no dynamic param differs), or None if the file is
        unchanged/missing/unparsable."""
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        if self._mtime is not None and mtime == self._mtime:
            return None
        self._mtime = mtime
        try:
            from vofod_tpu.io.yaml_lite import load_file

            doc = load_file(self.path) or {}
            # rebase on the node's LIVE params: a partial file overrides only
            # the keys it names — params tuned at startup (or by an earlier
            # poll) and then omitted from the file must not snap back to the
            # dataclass defaults
            fresh = DynParams.from_yaml_dict(doc, base=self.node.dyn)
        except Exception as e:
            _log.warning("[VoFOD]: param file %s unparsable (%s); keeping "
                         "previous parameters", self.path, e)
            return None
        changed = {
            f.name: getattr(fresh, f.name)
            for f in dataclasses.fields(DynParams)
            if getattr(fresh, f.name) != getattr(self.node.dyn, f.name)
        }
        for k in _RADII:
            if k in changed and not self.node.cfg.dynamic_radii:
                _log.warning(
                    "[VoFOD]: %s=%s ignored — it shapes compiled stencils "
                    "and the node was built with dynamic_radii=False",
                    k, changed.pop(k),
                )
        if changed:
            self.node.update_params(**changed)
            self.n_applied += 1
            _log.info("[VoFOD]: live params applied: %s", changed)
        return changed
