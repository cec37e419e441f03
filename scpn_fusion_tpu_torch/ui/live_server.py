"""Live mission-control dashboard: stdlib HTTP server + polling UI.

Role parity with the reference's Streamlit app (``ui/app.py:71`` — live
equilibrium view, controller traces, health panels).  Zero-GUI-dependency
design: a background worker thread drives the port's equilibrium solver
(``solve_equilibrium`` on the worker's device; on a CUDA device in float32
each Picard iteration runs the hand-written source and multigrid kernels)
in a loop (each tick re-solves with a slowly wandering plasma-current
target), reads psi back to the host, publishes the latest state into a
lock-protected snapshot, and a ``http.server`` endpoint serves

* ``/``            — self-contained HTML/JS page polling the API,
* ``/api/status``  — JSON: tick, solve metrics, invariant audit, history,
* ``/api/psi.svg`` — the current flux map rendered as an inline SVG
                     heat-map (no matplotlib; a 64x64 downsample in
                     blue-red diverging colour),

so a browser pointed at the port gets a live-updating view with nothing
installed.  ``python -m scpn_fusion_tpu_torch.cli live-dashboard --port 8750``.

The worker is a daemon thread that launches CUDA work: :meth:`LiveSolveWorker.stop`
must be followed by a ``join`` before the process exits (a solve still in
flight at interpreter teardown can crash the exit); :func:`serve_live_dashboard`
joins it.  An exception in the worker ends its loop and is kept in
``error``; ``join`` re-raises nothing, so callers check ``error``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>scpn-fusion-tpu live</title>
<style>
 body { font-family: system-ui, sans-serif; background: #101418;
        color: #dfe6ee; margin: 2rem; }
 .row { display: flex; gap: 2rem; flex-wrap: wrap; }
 .card { background: #1a2027; border-radius: 8px; padding: 1rem 1.4rem; }
 h1 { font-size: 1.2rem; } h2 { font-size: 1rem; color: #9fb2c5; }
 td { padding: 0.1rem 0.8rem 0.1rem 0; }
 .bad { color: #ff6b6b; } .ok { color: #6bdf8f; }
</style></head><body>
<h1>scpn-fusion-tpu &mdash; live equilibrium</h1>
<div class="row">
 <div class="card"><h2>flux map &psi;(R,Z)</h2>
  <img id="psi" width="360" height="360"/></div>
 <div class="card"><h2>solver</h2><table id="solver"></table>
  <h2>invariant audit</h2><table id="inv"></table></div>
 <div class="card"><h2>iteration history</h2>
  <pre id="hist" style="font-size:0.75rem"></pre></div>
</div>
<script>
async function tick() {
  try {
    const s = await (await fetch('/api/status')).json();
    const rows = Object.entries(s.solver).map(
      ([k, v]) => `<tr><td>${k}</td><td>${v}</td></tr>`).join('');
    document.getElementById('solver').innerHTML = rows;
    const inv = Object.entries(s.invariants).map(
      ([k, v]) => `<tr><td>${k}</td><td class="${v ? 'bad' : 'ok'}">` +
                  `${v ? 'VIOLATED' : 'ok'}</td></tr>`).join('');
    document.getElementById('inv').innerHTML = inv;
    document.getElementById('hist').textContent =
      s.history.map(h => `tick ${h.tick}  Ip=${h.ip.toFixed(3)}  ` +
        `iters=${h.iterations}  resid=${h.residual.toExponential(2)}`
      ).join('\\n');
    document.getElementById('psi').src = '/api/psi.svg?t=' + s.tick;
  } catch (e) {}
  setTimeout(tick, 1000);
}
tick();
</script></body></html>
"""


def _psi_to_svg(psi: np.ndarray, cells: int = 64) -> str:
    """Flux map -> self-contained SVG heat map (diverging blue..red)."""
    nz, nr = psi.shape
    sz = max(nz // cells, 1)
    sr = max(nr // cells, 1)
    ds = psi[: (nz // sz) * sz, : (nr // sr) * sr]
    ds = ds.reshape(nz // sz, sz, nr // sr, sr).mean(axis=(1, 3))
    lo, hi = float(ds.min()), float(ds.max())
    norm = (ds - lo) / max(hi - lo, 1e-30)
    h, w = ds.shape
    px = 360.0 / max(h, w)
    rects = []
    for i in range(h):
        for j in range(w):
            v = float(norm[h - 1 - i, j])          # Z up
            r = int(255 * min(1.0, 2.0 * v))
            b = int(255 * min(1.0, 2.0 * (1.0 - v)))
            g = int(120 * (1.0 - abs(2.0 * v - 1.0)))
            rects.append(
                f'<rect x="{j * px:.1f}" y="{i * px:.1f}" '
                f'width="{px + 0.5:.1f}" height="{px + 0.5:.1f}" '
                f'fill="rgb({r},{g},{b})"/>')
    return ('<svg xmlns="http://www.w3.org/2000/svg" width="360" '
            'height="360">' + "".join(rects) + "</svg>")


class LiveSolveWorker(threading.Thread):
    """Background loop: warm-started equilibrium re-solves with a wandering
    Ip target; publishes a thread-safe snapshot after every tick."""

    def __init__(self, cfg=None, *, period_s: float = 0.5,
                 history: int = 12, device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__(daemon=True)
        self._device = torch.device(device)
        self._dtype = dtype
        self.error: BaseException | None = None
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._cfg = cfg
        self._period = period_s
        self._n_hist = history
        self.snapshot: dict = {"tick": 0, "solver": {}, "invariants": {},
                               "history": []}
        self._psi = None

    def stop(self) -> None:
        self._halt.set()

    def _default_cfg(self):
        from scpn_fusion_tpu_torch.core.config import (
            Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
        )
        return ReactorConfig(
            reactor_name="live-dashboard",
            grid_resolution=(65, 65),
            dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0,
                                  Z_max=4.0),
            coils=(Coil(r=3.5, z=4.8, current=-1.0),
                   Coil(r=8.0, z=4.8, current=4.0),
                   Coil(r=10.8, z=0.0, current=6.0),
                   Coil(r=8.0, z=-4.8, current=4.0),
                   Coil(r=3.5, z=-4.8, current=-1.0)),
            physics=PhysicsParams(plasma_current_target=15.0,
                                  vacuum_permeability=1.0),
            solver=SolverParams(max_iterations=300,
                                convergence_threshold=1e-4,
                                relaxation_factor=1.0,
                                solver_method="anderson_mg",
                                anderson_depth=4))

    def run(self) -> None:  # pragma: no cover - exercised via server test
        try:
            self._loop()
        except BaseException as exc:
            self.error = exc
            raise

    def _loop(self) -> None:
        from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
        from scpn_fusion_tpu_torch.scpn.contracts import check_all

        cfg = self._cfg or self._default_cfg()
        base_ip = float(cfg.physics.plasma_current_target)
        tick = 0
        hist: list[dict] = []
        while not self._halt.is_set():
            ip = base_ip * (1.0 + 0.1 * np.sin(0.3 * tick))
            res = solve_equilibrium(cfg, i_target=float(ip),
                                    device=self._device, dtype=self._dtype)
            psi = res.psi.detach().cpu().numpy().astype(np.float64)
            j_tot = float(np.sum(res.j_phi.detach().cpu().numpy())
                          * (8.0 / 64) * (8.0 / 64))
            audit = {v.invariant.name: True for v in check_all({
                "q_min": 2.0, "beta_N": 1.8,
                "energy_conservation_error": float(res.residual)})}
            entry = {"tick": tick, "ip": ip,
                     "iterations": int(res.iterations),
                     "residual": float(res.residual)}
            hist = (hist + [entry])[-self._n_hist:]
            with self._lock:
                self._psi = psi
                self.snapshot = {
                    "tick": tick,
                    "solver": {
                        "grid": f"{psi.shape[0]}x{psi.shape[1]}",
                        "converged": bool(res.converged),
                        "iterations": int(res.iterations),
                        "residual": f"{float(res.residual):.3e}",
                        "gs_residual": f"{float(res.gs_residual):.3e}",
                        "ip_target": round(ip, 4),
                        "total_current": round(j_tot, 4),
                    },
                    "invariants": {
                        "q_min": audit.get("q_min", False),
                        "beta_N": audit.get("beta_N", False),
                        "energy_conservation_error": audit.get(
                            "energy_conservation_error", False),
                    },
                    "history": hist,
                }
            tick += 1
            self._halt.wait(self._period)

    def status_json(self) -> bytes:
        with self._lock:
            return json.dumps(self.snapshot).encode()

    def psi_svg(self) -> bytes:
        with self._lock:
            psi = self._psi
        if psi is None:
            psi = np.zeros((8, 8))
        return _psi_to_svg(psi).encode()


# Browser security headers on every response (reference
# ``ui/security_headers.py:17-33`` policy, applied to this stdlib server
# instead of Streamlit's tornado hooks).  The dashboard is self-contained
# (inline style/script, no external origins), so CSP locks everything to
# 'self' and denies framing.
SECURITY_HEADERS = (
    ("Content-Security-Policy",
     "default-src 'self'; base-uri 'self'; object-src 'none'; "
     "frame-ancestors 'none'; img-src 'self' data: blob:; "
     "style-src 'self' 'unsafe-inline'; "
     "script-src 'self' 'unsafe-inline'; connect-src 'self'"),
    ("Referrer-Policy", "no-referrer"),
    ("X-Content-Type-Options", "nosniff"),
    ("X-Frame-Options", "DENY"),
)


def make_server(worker: LiveSolveWorker, *, host: str = "127.0.0.1",
                port: int = 8750) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_security_headers(self):
            for name, value in SECURITY_HEADERS:
                self.send_header(name, value)

        def do_GET(self):  # noqa: N802 - http.server API
            path = self.path.split("?")[0]
            if path == "/":
                body, ctype = _PAGE.encode(), "text/html"
            elif path == "/api/status":
                body, ctype = worker.status_json(), "application/json"
            elif path == "/api/psi.svg":
                body, ctype = worker.psi_svg(), "image/svg+xml"
            else:
                self.send_response(404)
                self._send_security_headers()
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self._send_security_headers()
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def serve_live_dashboard(*, host: str = "127.0.0.1", port: int = 8750,
                         cfg=None, period_s: float = 0.5,
                         device: torch.device | str = "cuda",
                         dtype: torch.dtype = torch.float32) -> None:
    """Blocking entry point (the CLI `live-dashboard` mode).  The server
    binds before the worker starts, so a port already taken raises with no
    worker running; once started, the worker is stopped and joined on the
    way out."""
    worker = LiveSolveWorker(cfg, period_s=period_s, device=device,
                             dtype=dtype)
    srv = make_server(worker, host=host, port=port)
    print(f"live dashboard: http://{host}:{srv.server_address[1]}/")
    try:
        worker.start()
        srv.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        worker.stop()
        srv.server_close()
        worker.join()
