"""Live web dashboard for fleet telemetry, counterpart of the JAX package's
``dashboard_web.py``: a stdlib ``http.server`` in a background thread serves
an auto-refreshing page (fleet table and 2D position trails) and
``metrics.json``, a snapshot of the same :class:`~.metrics.MetricsLog` that
:mod:`.dashboard` renders as text.

Usage::

    server = DashboardServer(log).start()   # log: MetricsLog, shared with
    print(server.url)                       # the running MultiRobotDriver
    ...
    server.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsLog

_PAGE = """<!DOCTYPE html>
<html><head><title>mpc fleet dashboard</title><style>
body { font-family: monospace; background: #111; color: #ddd; margin: 1em; }
table { border-collapse: collapse; margin-bottom: 1em; }
td, th { border: 1px solid #444; padding: 2px 10px; text-align: right; }
th { background: #222; }
td.ok { color: #6c6; } td.fail { color: #e66; }
canvas { border: 1px solid #444; background: #181818; }
</style></head><body>
<h3>fleet telemetry</h3>
<table id="t"><thead><tr>
<th>robot</th><th>state</th><th>solver</th><th>topo</th><th>obj</th>
<th>comm</th><th>v</th><th>ms</th><th>success%</th><th>comm%</th>
</tr></thead><tbody></tbody></table>
<canvas id="c" width="600" height="400"></canvas>
<script>
const trails = {};
async function tick() {
  try {
    const r = await fetch('metrics.json'); const d = await r.json();
    const tb = document.querySelector('#t tbody'); tb.innerHTML = '';
    for (const row of d.robots) {
      const tr = document.createElement('tr');
      tr.innerHTML = `<td>${row.ns}</td><td>${row.state}</td>` +
        `<td class="${row.solver_success ? 'ok' : 'fail'}">` +
        `${row.solver_success ? 'OK' : 'FAIL'}</td>` +
        `<td>${row.topology}</td><td>${row.objective.toFixed(3)}</td>` +
        `<td>${row.comm}</td><td>${row.velocity.toFixed(2)}</td>` +
        `<td>${row.planning_ms.toFixed(1)}</td>` +
        `<td>${(100 * row.success_rate).toFixed(1)}</td>` +
        `<td>${(100 * row.comm_rate).toFixed(1)}</td>`;
      tb.appendChild(tr);
      (trails[row.ns] = trails[row.ns] || []).push([row.x, row.y]);
      if (trails[row.ns].length > 400) trails[row.ns].shift();
    }
    draw();
  } catch (e) {}
  setTimeout(tick, 500);
}
function draw() {
  const c = document.getElementById('c'), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  let xs = [], ys = [];
  for (const ns in trails) for (const p of trails[ns]) {
    xs.push(p[0]); ys.push(p[1]);
  }
  if (!xs.length) return;
  const pad = 1.0;
  const x0 = Math.min(...xs) - pad, x1 = Math.max(...xs) + pad;
  const y0 = Math.min(...ys) - pad, y1 = Math.max(...ys) + pad;
  const s = Math.min(c.width / (x1 - x0), c.height / (y1 - y0));
  const X = x => (x - x0) * s, Y = y => c.height - (y - y0) * s;
  const colors = ['#6c6', '#69f', '#e96', '#c6c', '#cc6', '#6cc'];
  let i = 0;
  for (const ns in trails) {
    const col = colors[i++ % colors.length], tr = trails[ns];
    g.strokeStyle = col; g.beginPath();
    tr.forEach((p, j) => j ? g.lineTo(X(p[0]), Y(p[1]))
                           : g.moveTo(X(p[0]), Y(p[1])));
    g.stroke();
    const last = tr[tr.length - 1];
    g.fillStyle = col;
    g.beginPath(); g.arc(X(last[0]), Y(last[1]), 5, 0, 7); g.fill();
    g.fillText(ns, X(last[0]) + 8, Y(last[1]));
  }
}
tick();
</script></body></html>"""


def snapshot(log: MetricsLog) -> dict:
    """JSON-able snapshot of the latest per-robot telemetry (the pull-based
    twin of dashboard.render_dashboard's table)."""
    robots = []
    for ns in sorted(log.records):
        recs = log.records[ns]
        if not recs:
            continue
        m = recs[-1]
        robots.append({
            "ns": ns, "state": m.planner_state,
            "solver_success": bool(m.solver_success),
            "topology": int(m.selected_topology_id),
            "objective": float(m.objective),
            "comm": m.communication_trigger if m.communicated else "-",
            "velocity": float(m.velocity),
            "planning_ms": float(m.planning_time_ms),
            "x": float(m.position_x), "y": float(m.position_y),
            "success_rate": float(log.success_rate(ns)),
            "comm_rate": float(log.communication_rate(ns)),
            "n_records": len(recs),
        })
    return {"robots": robots}


class DashboardServer:
    """Background HTTP server for the live dashboard."""

    def __init__(self, log: MetricsLog, host: str = "127.0.0.1",
                 port: int = 0):
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path == "/metrics.json":
                    body = json.dumps(snapshot(dash.log)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        self.log = log
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "DashboardServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
