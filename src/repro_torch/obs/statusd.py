"""Live fleet status endpoint: stdlib-only HTTP over the obs plane.

Opt-in and OFF by default: nothing binds a port, spawns a thread, or
touches a hot path until ``StatusServer(...).start()`` is called, and
every request is answered by READING the same snapshot/rollup APIs the
benchmarks use — the instrumented paths never know the server exists
(the fig_health on/off throughput gate runs with it live).

Routes (all JSON unless noted):

- ``/healthz``  liveness + obs pillar states + uptime
- ``/fleet``    per-node registry rollup (lease state, health verdict,
                z-score, capacity, waves, failures, cost), pump stats,
                fleet-summed node metrics
- ``/slo``      per-class TTFT/TPOT summary + SLO attainment (from the
                serve-stats provider when wired, else the ``serve.*``
                histograms)
- ``/series``   ``?name=X&n=N`` one series tail; without ``name``, the
                list of series names
- ``/``         one self-contained HTML page: fleet map colored by
                health verdict, pump busy, per-class SLO attainment —
                no external assets, works from ``file://`` or curl

Construction takes the pieces it should expose: a ``NodeRegistry``
(fleet + health), an optional ``pump`` (``snapshot()``), an optional
``serve_stats`` callable returning an engine's ``stats`` dict. Binds
``127.0.0.1`` on an ephemeral port by default — status is an operator
surface, not a public one.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

__all__ = ["StatusServer"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>fleet status</title><style>
body{font:14px/1.4 system-ui,sans-serif;margin:24px;background:#111;
color:#ddd}
h1{font-size:18px} h2{font-size:15px;margin-top:24px;color:#aaa}
#nodes{display:flex;flex-wrap:wrap;gap:6px;max-width:900px}
.node{width:86px;padding:6px 8px;border-radius:6px;font-size:11px;
color:#111;background:#4c4}
.node.degraded{background:#dc3} .node.outlier{background:#e55;color:#fff}
.node.suspect{outline:2px dashed #dc3} .node.dead{background:#555;
color:#bbb} .node.left{background:#333;color:#888}
.node b{display:block;font-size:12px;overflow:hidden;
text-overflow:ellipsis}
table{border-collapse:collapse;margin-top:6px}
td,th{padding:2px 10px 2px 0;text-align:left;font-size:13px}
#bar{width:240px;height:10px;background:#333;border-radius:5px;
display:inline-block;vertical-align:middle}
#fill{height:10px;background:#4c4;border-radius:5px;width:0}
small{color:#888}</style></head><body>
<h1>fleet status</h1>
<h2>nodes <small id="counts"></small></h2><div id="nodes"></div>
<h2>pump <small>busy fraction</small></h2>
<div id="bar"><div id="fill"></div></div> <span id="busy"></span>
<h2>serving SLO</h2><table id="slo"></table>
<small id="ts"></small>
<script>
async function tick(){
 try{
  const f=await (await fetch('/fleet')).json();
  const box=document.getElementById('nodes'); box.innerHTML='';
  const counts={};
  for(const [id,n] of Object.entries(f.nodes||{})){
   const v=(n.health&&n.health.verdict)||'healthy';
   counts[v]=(counts[v]||0)+1;
   const d=document.createElement('div');
   d.className='node '+v+' '+(n.state||'');
   d.title=JSON.stringify(n);
   d.innerHTML='<b>'+id+'</b>'+(n.state||'')+' z='
     +((n.health&&n.health.z!=null)?n.health.z:'-');
   box.appendChild(d);
  }
  document.getElementById('counts').textContent=
    Object.entries(counts).map(([k,v])=>v+' '+k).join(', ');
  const busy=(f.pump&&f.pump.busy_frac)||0;
  document.getElementById('fill').style.width=
    Math.min(100,busy*100)+'%';
  document.getElementById('fill').style.background=
    busy>0.9?'#e55':(busy>0.6?'#dc3':'#4c4');
  document.getElementById('busy').textContent=busy.toFixed(3);
  const s=await (await fetch('/slo')).json();
  const t=document.getElementById('slo');
  t.innerHTML='<tr><th>class</th><th>n</th><th>p50 TTFT</th>'
    +'<th>p50 TPOT</th><th>preempt</th></tr>';
  for(const [c,r] of Object.entries(s.classes||{})){
   t.innerHTML+='<tr><td>'+c+'</td><td>'+r.n+'</td><td>'
     +(r.p50_ttft_s||0).toFixed(4)+'s</td><td>'
     +(r.p50_tpot_s||0).toFixed(5)+'s</td><td>'
     +(r.preemptions||0)+'</td></tr>';
  }
  if(s.slo_attainment!=null)
    t.innerHTML+='<tr><td><b>attainment</b></td><td colspan=4>'
      +(100*s.slo_attainment).toFixed(1)+'% (target '
      +s.target_first_result_s+'s)</td></tr>';
  document.getElementById('ts').textContent=
    'updated '+new Date().toLocaleTimeString();
 }catch(e){document.getElementById('ts').textContent='fetch failed: '+e}
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""


class StatusServer:
    """One daemon thread serving live obs state; ``start()``/``stop()``."""

    def __init__(self, registry: Any = None, pump: Any = None,
                 serve_stats: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 slo_s: Optional[float] = None) -> None:
        self.registry = registry
        self.pump = pump
        self.serve_stats = serve_stats
        self.slo_s = slo_s
        self._host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    # -- lifecycle --------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def address(self) -> Optional[tuple]:
        return self._httpd.server_address if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        addr = self.address
        return f"http://{addr[0]}:{addr[1]}" if addr else None

    def start(self) -> "StatusServer":
        if self._httpd is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # status polls are not access
                pass                        # logs worth a stderr line

            def do_GET(self):
                outer._handle(self)

        self._t0 = time.time()
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="obs-statusd")
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- payload builders -------------------------------------------------
    def payload_healthz(self) -> dict:
        return {"ok": True, "t": time.time(),
                "uptime_s": time.time() - self._t0,
                "tracing": TRACER.enabled, "metrics": REGISTRY.enabled}

    def payload_fleet(self) -> dict:
        nodes: Dict[str, dict] = {}
        if self.registry is not None:
            rollup = self.registry.rollup()
            detail = {}
            he = getattr(self.registry, "health", None)
            if he is not None:
                he.evaluate()
                detail = he.detail()
            for nid, row in rollup.items():
                row = dict(row)
                row["health"] = detail.get(
                    nid, {"verdict": "healthy", "z": 0.0})
                nodes[nid] = row
        pump: dict = {}
        if self.pump is not None:
            try:
                snap = self.pump.snapshot()
            except Exception:
                snap = {}
            pump = {k: snap.get(k) for k in
                    ("busy_frac", "frames_in", "frames_out", "bytes_in",
                     "bytes_out", "conns") if k in snap}
        return {"nodes": nodes, "pump": pump,
                "node_metrics": REGISTRY.nodes_rollup()}

    def payload_slo(self) -> dict:
        out: dict = {"classes": {}, "slo_attainment": None,
                     "target_first_result_s": self.slo_s}
        if self.serve_stats is not None:
            try:
                stats = self.serve_stats() or {}
            except Exception:
                stats = {}
            out["classes"] = stats.get("classes", {})
            out["slo_attainment"] = stats.get("slo_attainment")
            out["decoded"] = stats.get("decoded")
            out["preemptions"] = stats.get("preemptions")
        else:
            snap = REGISTRY.snapshot()
            h = snap.get("serve.ttft_s")
            if isinstance(h, dict) and h.get("count"):
                out["classes"] = {"all": {
                    "n": h["count"],
                    "mean_ttft_s": h["sum"] / h["count"]}}
        return out

    def payload_series(self, name: Optional[str], n: int) -> dict:
        if not name:
            return {"names": sorted(REGISTRY.series_names())}
        return {"name": name,
                "points": [[t, v]
                           for t, v in REGISTRY.series_tail(name, n)]}

    # -- request plumbing -------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        try:
            url = urlparse(req.path)
            route = url.path.rstrip("/") or "/"
            if route == "/":
                body = _PAGE.encode()
                ctype = "text/html; charset=utf-8"
            else:
                if route == "/healthz":
                    doc = self.payload_healthz()
                elif route == "/fleet":
                    doc = self.payload_fleet()
                elif route == "/slo":
                    doc = self.payload_slo()
                elif route == "/series":
                    q = parse_qs(url.query)
                    doc = self.payload_series(
                        (q.get("name") or [None])[0],
                        int((q.get("n") or ["128"])[0]))
                else:
                    req.send_error(404)
                    return
                body = json.dumps(doc, default=str).encode()
                ctype = "application/json"
            req.send_response(200)
            req.send_header("Content-Type", ctype)
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
        except BrokenPipeError:
            pass
        except Exception as e:               # a status bug must never
            try:                             # crash the serving thread
                req.send_error(500, str(e))
            except Exception:
                pass
