"""Terminal dashboard for fleet telemetry, counterpart of the JAX package's
``dashboard.py``: one text frame of the latest per-robot
:class:`~.metrics.MPCMetrics` and each robot's success and communication
rates, rendered on demand from a :class:`~.metrics.MetricsLog`.
"""

from __future__ import annotations

from typing import Optional

from .metrics import MetricsLog


def render_dashboard(log: MetricsLog, width: int = 100) -> str:
    """One dashboard frame as text."""
    lines = []
    lines.append("=" * width)
    lines.append(f"{'robot':<12}{'state':<24}{'solver':<9}{'topo':<6}"
                 f"{'guid':<6}{'obj':>10}{'comm':<18}{'v':>6}{'ms':>8}")
    lines.append("-" * width)
    for ns, recs in sorted(log.records.items()):
        if not recs:
            continue
        m = recs[-1]
        lines.append(
            f"{ns:<12}{m.planner_state:<24}"
            f"{'OK' if m.solver_success else 'FAIL':<9}"
            f"{m.selected_topology_id:<6}{m.num_guidance_found:<6}"
            f"{m.objective:>10.3f}"
            f"{(m.communication_trigger if m.communicated else '-'):<18}"
            f"{m.velocity:>6.2f}{m.planning_time_ms:>8.1f}")
    lines.append("-" * width)
    for ns in sorted(log.records):
        lines.append(
            f"{ns}: success {log.success_rate(ns)*100:5.1f}% | "
            f"comm rate {log.communication_rate(ns)*100:5.1f}% "
            f"(bandwidth saving {100*(1-log.communication_rate(ns)):.0f}%)")
    lines.append("=" * width)
    return "\n".join(lines)


def live_dashboard(log: MetricsLog, refresh_s: float = 0.5,
                   n_frames: Optional[int] = None) -> None:
    """Continuously re-render (for interactive monitoring)."""
    import sys
    import time

    frame = 0
    while n_frames is None or frame < n_frames:
        sys.stdout.write("\x1b[2J\x1b[H" + render_dashboard(log) + "\n")
        sys.stdout.flush()
        time.sleep(refresh_s)
        frame += 1
