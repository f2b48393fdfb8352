"""Live interactive tracking-debug dashboard (visdom replacement), port of
mmtrack_tpu/vis_server.py.

Rebuild of the reference's interactive debug loop - the 497-line visdom
UI (ViPT/lib/vis/visdom_cus.py) that basetracker.py:59-83 and DeT
dimp.py:161-165 feed with per-frame score-map heatmaps, tracking
overlays and status dicts, with pause/single-step keyboard control -
without the visdom dependency. A stdlib http.server on localhost serves a
single-page UI that polls JSON endpoints; the tracking loop stays
host-side Python.

  - ``register(data, plot_type, debug_level, title)`` - the
    Visdom-facade signature trackers call (visdom_cus.py register);
    plot types 'image', 'heatmap', 'histogram', 'lineplot', 'tracking'
    ((frame, box[, segmentation]) overlay), 'info_dict', 'text'. Data
    above the dashboard's debug level is dropped. Tensors (on the card
    or not) are read to the host once, in `_to_host`, when registered.
  - pause/step: Space toggles pause, ArrowRight / 'n' advances a single
    frame while paused; the tracking loop calls ``wait_if_paused()`` once
    per frame (eval/ope.py::run_sequence, mmtrack_torch.demo).

The JSON of /state and /data is the JAX module's for the same calls
(tests/test_torch_vis_server.py).

Use:
    dash = DebugDashboard()          # prints the URL
    ...
    dash.register((frame, box), 'tracking', 1, 'Tracking')
    dash.register(score_map, 'heatmap', 1, 'Score Map')
    dash.wait_if_paused()
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>mmtrack_torch debug</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:12px}
.panel{display:inline-block;vertical-align:top;margin:8px;padding:8px;
       background:#1c1c1c;border:1px solid #333;border-radius:6px}
.panel h3{margin:0 0 6px 0;font-size:13px;color:#8cf}
#bar{margin-bottom:8px}
button{background:#333;color:#ddd;border:1px solid #555;padding:4px 10px;
       margin-right:6px;border-radius:4px;cursor:pointer}
canvas,img{image-rendering:pixelated;max-width:480px}
table{font-size:12px} td{padding:1px 8px 1px 0}
.paused{color:#f66}
</style></head><body>
<div id="bar">
 <button onclick="ctl('pause')">pause/resume [Space]</button>
 <button onclick="ctl('step')">step [&rarr;]</button>
 <span id="status"></span>
</div>
<div id="panels"></div>
<script>
const panels = {};
function ctl(a){fetch('/control',{method:'POST',body:JSON.stringify({action:a})});}
document.addEventListener('keydown', e => {
  if (e.code === 'Space'){e.preventDefault(); ctl('pause');}
  if (e.code === 'ArrowRight' || e.key === 'n') ctl('step');
});
function panel(title){
  if (panels[title]) return panels[title];
  const d = document.createElement('div'); d.className = 'panel';
  d.innerHTML = '<h3>'+title+'</h3><div class="body"></div>';
  document.getElementById('panels').appendChild(d);
  return panels[title] = {div: d, body: d.querySelector('.body'), seq: -1};
}
function heat(v){ // v in [0,1] -> JET-ish
  const r = Math.min(Math.max(1.5-Math.abs(4*v-3),0),1);
  const g = Math.min(Math.max(1.5-Math.abs(4*v-2),0),1);
  const b = Math.min(Math.max(1.5-Math.abs(4*v-1),0),1);
  return [r*255,g*255,b*255];
}
async function renderOne(title, info){
  const p = panel(title);
  if (info.seq === p.seq) return;
  const r = await fetch('/data?title='+encodeURIComponent(title));
  const d = await r.json();
  p.seq = info.seq;
  if (d.type === 'image' || d.type === 'tracking'){
    p.body.innerHTML = '<img src="data:image/jpeg;base64,'+d.jpeg+'">';
  } else if (d.type === 'heatmap' || d.type === 'histogram'){
    let c = p.body.querySelector('canvas');
    if (!c){p.body.innerHTML=''; c=document.createElement('canvas');
            p.body.appendChild(c);
            p.body.insertAdjacentHTML('beforeend','<div class="mm"></div>');}
    const h=d.values.length, w=d.values[0].length;
    c.width=w; c.height=h; c.style.width=Math.min(w*8,480)+'px';
    const ctx=c.getContext('2d'); const im=ctx.createImageData(w,h);
    const lo=d.min, span=(d.max-d.min)||1;
    for(let y=0;y<h;y++)for(let x=0;x<w;x++){
      const [R,G,B]=heat((d.values[y][x]-lo)/span);
      const i=(y*w+x)*4; im.data[i]=R; im.data[i+1]=G; im.data[i+2]=B;
      im.data[i+3]=255;}
    ctx.putImageData(im,0,0);
    p.body.querySelector('.mm').textContent =
      'min '+d.min.toFixed(4)+'  max '+d.max.toFixed(4);
  } else if (d.type === 'lineplot'){
    let c = p.body.querySelector('canvas');
    if (!c){p.body.innerHTML=''; c=document.createElement('canvas');
            c.width=360; c.height=140; p.body.appendChild(c);}
    const ctx=c.getContext('2d'); ctx.clearRect(0,0,c.width,c.height);
    ctx.strokeStyle='#8cf'; ctx.beginPath();
    const ys=d.values; const n=ys.length||1;
    const lo=Math.min(...ys,0), hi=Math.max(...ys,1e-9), span=(hi-lo)||1;
    ys.forEach((v,i)=>{const X=i/(n-1||1)*350+5,
      Y=135-(v-lo)/span*125; i?ctx.lineTo(X,Y):ctx.moveTo(X,Y);});
    ctx.stroke();
    p.body.insertAdjacentHTML('beforeend','');
  } else if (d.type === 'info_dict' || d.type === 'text'){
    if (d.type === 'text'){p.body.textContent = d.text;}
    else {p.body.innerHTML = '<table>'+Object.entries(d.info).map(
      ([k,v])=>'<tr><td>'+k+'</td><td>'+v+'</td></tr>').join('')+'</table>';}
  }
}
async function tick(){
  try{
    const r = await fetch('/state'); const s = await r.json();
    document.getElementById('status').innerHTML =
      'frame <b>'+s.frame+'</b> '+(s.paused?'<span class="paused">PAUSED</span>':'running');
    for (const [t, info] of Object.entries(s.titles)) await renderOne(t, info);
  }catch(e){}
  setTimeout(tick, 250);
}
tick();
</script></body></html>"""


class DebugDashboard:
    """Serves the UI; trackers call register() + wait_if_paused()."""

    def __init__(self, port: int = 0, debug: int = 1,
                 pause_mode: bool = False, log=print):
        self.debug = debug
        self._lock = threading.Lock()
        self._store: dict[str, dict] = {}
        self._seq = 0
        self.frame_num = 0
        self._paused = pause_mode
        self._step = threading.Event()

        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/state":
                    with dash._lock:
                        titles = {t: {"seq": e["seq"], "type": e["type"]}
                                  for t, e in dash._store.items()}
                    self._json({"titles": titles, "paused": dash._paused,
                                "frame": dash.frame_num})
                elif self.path.startswith("/data"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    title = q.get("title", [""])[0]
                    with dash._lock:
                        entry = dash._store.get(title)
                    if entry is None:
                        self._json({"error": "unknown title"}, 404)
                    else:
                        self._json(dash._render(entry))
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                if self.path == "/control":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        action = json.loads(self.rfile.read(n)).get("action")
                    except Exception:
                        action = None
                    if action == "pause":
                        dash._paused = not dash._paused
                    elif action == "step":
                        dash._step.set()
                    elif action == "resume":
                        dash._paused = False
                    self._json({"paused": dash._paused})
                else:
                    self._json({"error": "not found"}, 404)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        if log:
            log(f"debug dashboard: http://127.0.0.1:{self.port}/ "
                f"(Space = pause, ArrowRight = step)")

    # -- tracker-facing API (visdom_cus.py register signature) ----------
    def register(self, data, plot_type: str = "image", debug_level: int = 0,
                 title: str = "Data") -> None:
        if debug_level > self.debug:
            return
        entry = {"type": plot_type, "data": self._to_host(data)}
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._store[title] = entry

    def wait_if_paused(self, poll: float = 0.05) -> None:
        """Per-frame gate: blocks while paused; a pending step request
        releases exactly one frame (reference pause_mode/step flags)."""
        self.frame_num += 1
        while self._paused:
            if self._step.is_set():
                self._step.clear()
                return
            time.sleep(poll)

    def close(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=2)

    # -- rendering -------------------------------------------------------
    @staticmethod
    def _to_host(data):
        if isinstance(data, (tuple, list)):
            return [DebugDashboard._to_host(d) for d in data]
        if isinstance(data, dict):
            return {k: DebugDashboard._to_host(v) for k, v in data.items()}
        if isinstance(data, torch.Tensor):
            data = data.detach()
            if data.dtype == torch.bfloat16:
                data = data.float()
            return data.cpu().numpy()
        if hasattr(data, "shape"):
            return np.asarray(data)
        return data

    def _render(self, entry: dict) -> dict:
        t, d = entry["type"], entry["data"]
        if t == "tracking":
            frame = np.asarray(d[0])
            boxes = d[1] if len(d) > 1 else None
            seg = d[2] if len(d) > 2 else None
            from mmtrack_torch.vis import draw_box, overlay_mask

            im = frame[..., :3].astype(np.uint8)
            if seg is not None:
                im = overlay_mask(im, np.asarray(seg))
            if boxes is not None:
                bs = boxes if isinstance(boxes[0], (list, tuple, np.ndarray)) \
                    else [boxes]
                for b in bs:
                    im = draw_box(im, b)[..., ::-1]  # back to RGB
            return {"type": t, "seq": entry["seq"], "jpeg": _jpeg_b64(im)}
        if t == "image":
            im = np.asarray(d)
            if im.ndim == 3 and im.shape[0] in (1, 3) and im.shape[-1] > 4:
                im = np.moveaxis(im, 0, -1)  # CHW -> HWC (visdom convention)
            im = np.squeeze(im)
            if im.dtype != np.uint8:
                lo, hi = float(im.min()), float(im.max())
                im = ((im - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
            return {"type": t, "seq": entry["seq"], "jpeg": _jpeg_b64(im)}
        if t in ("heatmap", "histogram"):
            v = np.asarray(np.squeeze(d), np.float64)
            if t == "histogram":
                hist, _ = np.histogram(v.reshape(-1), bins=32)
                v = hist[None].astype(np.float64)
            return {"type": "heatmap", "seq": entry["seq"],
                    "values": v.tolist(),
                    "min": float(v.min()), "max": float(v.max())}
        if t == "lineplot":
            v = np.asarray(d, np.float64).reshape(-1)
            return {"type": t, "seq": entry["seq"], "values": v.tolist()}
        if t == "info_dict":
            return {"type": t, "seq": entry["seq"],
                    "info": {str(k): str(v) for k, v in dict(d).items()}}
        return {"type": "text", "seq": entry["seq"], "text": str(d)}


def _jpeg_b64(im: np.ndarray) -> str:
    import cv2

    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(im[..., ::-1]))
    if not ok:
        raise ValueError("jpeg encode failed")
    return base64.b64encode(buf.tobytes()).decode()
