"""Browser spectrum/waterfall display served over plain HTTP (the port's
copy of ``cutesdr_tpu/serve.py``: numpy and ``http.server`` alone; a test
holds it equal to the JAX package's).  It drives any session of the port
(``ReceiverSession``, ``DiversitySession``, ``BankSession``) through its
callbacks.

Reference analogue: the Qt CPlotter widget (gui/plotter.cpp): a 2D
spectrum and scrolling waterfall with click-to-tune and draggable demod
filter edges (gui/plotter.cpp:140-372).  Here a dependency-free
http.server hosting a canvas page; spectrum frames are pushed over
Server-Sent Events (GET /events) the moment the display path produces
them, with /spectrum.json kept as a pull fallback.  Tune clicks and
filter-edge drags POST back to the session; the page just draws rows.

Display controls (all client-side, mirroring the reference's display
dialog + plotter knobs):
  * waterfall palette — the reference's 256-entry blue→cyan→green→yellow→
    red→pink ramp (color-table data from gui/plotter.cpp:70-83) plus a
    grayscale alternative;
  * max/min dB range (m_MaxdB / m_MindB, gui/plotter.cpp:101-102);
  * span zoom (m_Span, gui/plotter.h:41) — zoomed views center on the
    demod tune frequency (divergence: the reference centers on the LO);
  * 2D/waterfall screen split (SetPercent2DScreen, gui/plotter.h:35);
  * A/D-overload turns the 2D trace red (gui/plotter.cpp:458-468);
  * per-channel mini-waterfalls in the bank table (no reference analogue —
    the bank itself has none).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>cutesdr-tpu</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
canvas{display:block;margin-top:4px;image-rendering:pixelated}
#bar{margin:6px 0}
#ctl{margin:4px 0;color:#9ab}
#ctl input,#ctl select{background:#222;color:#ddd;border:1px solid #555}
#ctl input[type=number]{width:4.5em}
</style></head><body>
<div id="bar">cutesdr-tpu — <span id="status">connecting…</span></div>
<div id="freqctrl" title="per-digit tuning: wheel or click upper/lower half;
type digits after clicking one" style="font-size:28px;letter-spacing:1px;
cursor:ns-resize;user-select:none;margin:2px 0"></div>
<div id="ctl">
 <select id="mode" style="display:none"><option>am</option><option>sam</option>
   <option>fm</option><option>usb</option><option>lsb</option>
   <option>cwu</option><option>cwl</option></select>
 max dB <input id="maxdb" type="number" value="0" step="5">
 min dB <input id="mindb" type="number" value="-120" step="5">
 zoom <select id="zoom"><option>1</option><option>2</option><option>4</option>
   <option>8</option><option>16</option><option>32</option></select>
 palette <select id="pal"><option value="cute">cuteSDR</option>
   <option value="gray">grayscale</option></select>
 2D <input id="split" type="range" min="10" max="90" value="40"
   style="width:90px;vertical-align:middle"> wfall
 <button id="audio" title="stream demodulated audio (chunked WAV)">&#128266; audio</button>
 vol <input id="vol" type="range" min="0" max="99" value="99"
   style="width:80px;vertical-align:middle">
 probe <select id="probe"><option value="off">off</option>
   <option value="p1">p1 downconvert</option>
   <option value="p2">p2 fastfir</option><option value="p3">p3 agc</option>
   <option value="p4">p4 demod</option>
   <option value="p5">p5 resampled</option>
   <option value="p6">p6 pll</option>
   <option value="p7">p7 blanker</option></select>
 <select id="probeview"><option value="spectrum">spectrum</option>
   <option value="scope">scope</option></select>
</div>
<canvas id="spec" width="1024" height="200"></canvas>
<canvas id="wf" width="1024" height="300"></canvas>
<div id="probebar" style="display:none;color:#9ab"></div>
<canvas id="probecv" width="1024" height="140" style="display:none"></canvas>
<table id="chlist" style="border-collapse:collapse;margin-top:6px"></table>
<script>
const spec = document.getElementById('spec'), wf = document.getElementById('wf');
const sctx = spec.getContext('2d'), wctx = wf.getContext('2d');
let view = {tune_hz:0, low_hz:-5000, hi_hz:5000, symmetric:false,
            sample_rate:2e6, min_db:-120, max_db:0};
// display controls (reference: displaydlg + CPlotter knobs)
let maxdb = 0, mindb = -120, zoom = 1, pct2d = 40;
const TOTAL_H = 500;
let lastFrame = null;
function makePalette(name){
  // 256-entry color ramp; 'cute' is the reference's waterfall color-table
  // data (gui/plotter.cpp:70-83): blue -> cyan -> green -> yellow -> red -> pink
  const t = [];
  for (let i = 0; i < 256; i++){
    let r = 0, g = 0, b = 0;
    if (name === 'gray'){ r = g = b = i; }
    else if (i < 43)      { b = 255*i/43; }
    else if (i < 87)      { g = 255*(i-43)/43; b = 255; }
    else if (i < 120)     { g = 255; b = 255 - 255*(i-87)/32; }
    else if (i < 154)     { r = 255*(i-120)/33; g = 255; }
    else if (i < 217)     { r = 255; g = 255 - 255*(i-154)/62; }
    else                  { r = 255; b = 128*(i-217)/38; }
    t.push([r|0, g|0, b|0]);
  }
  return t;
}
let palette = makePalette('cute');
function palColor(v){ // 0..1 -> rgb
  return palette[Math.max(0, Math.min(255, Math.floor(v*255)))];
}
// span zoom: the displayed window is sample_rate/zoom wide, centered on the
// tune frequency (clamped inside the digitized band; the reference's m_Span,
// centered on the LO — see module docstring for the divergence note)
const spanHz = () => view.sample_rate / zoom;
function spanCenter(){
  if (zoom === 1) return 0;
  const lim = (view.sample_rate - spanHz()) / 2;
  return Math.max(-lim, Math.min(lim, view.tune_hz));
}
const fx = f => ((f - spanCenter())/spanHz() + 0.5) * spec.width; // freq->px
const xf = x => (x/spec.width - 0.5) * spanHz() + spanCenter();   // px->freq
function binsForPx(x, n){  // pixel column -> [i0, i1) fft-bin range, max-hold
  const sr = view.sample_rate;
  const f0 = xf(x), f1 = xf(x + 1);
  let i0 = Math.floor((f0/sr + 0.5) * n), i1 = Math.ceil((f1/sr + 0.5) * n);
  i0 = Math.max(0, Math.min(n - 1, i0));
  i1 = Math.max(i0 + 1, Math.min(n, i1));
  return [i0, i1];
}
function pxDb(d, x){
  const [i0, i1] = binsForPx(x, d.db.length);
  let m = -1e9;
  for (let i = i0; i < i1; i++) if (d.db[i] > m) m = d.db[i];
  return m;
}
function drawFrame(d){
  lastFrame = d;
  wheelTarget = null;        // frame confirms the tune; next wheel re-bases
  Object.assign(view, {tune_hz:d.tune_hz, low_hz:d.low_hz, hi_hz:d.hi_hz,
    symmetric:d.symmetric, sample_rate:d.sample_rate,
    rf_center:d.rf_center ?? view.rf_center ?? 0,
    click_res:d.click_res ?? view.click_res});
  syncMode(d);
  document.getElementById('status').textContent =
    `fs=${d.sample_rate} Hz  tune=${(d.tune_hz/1e3).toFixed(3)} kHz  `+
    `filter ${d.low_hz}..${d.hi_hz} Hz  `+
    `S-meter=${d.smeter_db?.toFixed(1)??'n/a'} dB`+
    (d.overload ? '  [A/D OVERLOAD]' : '');
  const W = spec.width, H = spec.height;
  sctx.fillStyle='#111'; sctx.fillRect(0,0,W,H);
  // demod passband shading + edge/center markers
  const x0 = fx(d.tune_hz + d.low_hz), x1 = fx(d.tune_hz + d.hi_hz);
  sctx.fillStyle='rgba(80,160,255,0.15)'; sctx.fillRect(x0,0,x1-x0,H);
  sctx.strokeStyle='#f44'; sctx.beginPath();
  sctx.moveTo(fx(d.tune_hz),0); sctx.lineTo(fx(d.tune_hz),H); sctx.stroke();
  sctx.strokeStyle='rgba(120,200,255,0.8)';
  for (const xe of [x0,x1]) { sctx.beginPath();
    sctx.moveTo(xe,0); sctx.lineTo(xe,H); sctx.stroke(); }
  // overload turns the trace red (gui/plotter.cpp:458-468)
  sctx.strokeStyle = d.overload ? '#f33' : '#4cf';
  sctx.beginPath();
  for(let x=0;x<W;x++){
    const y=(1-(pxDb(d,x)-mindb)/(maxdb-mindb))*H;
    if(x===0)sctx.moveTo(x,y);else sctx.lineTo(x,y);
  }
  sctx.stroke();
  // channel-bank markers + table
  if (d.channels && d.channels.length) {
    for (const c of d.channels) {
      const x = fx(c.tune_hz);
      sctx.strokeStyle = c.monitor ? '#fc0' : 'rgba(255,200,0,0.4)';
      sctx.beginPath(); sctx.moveTo(x,0); sctx.lineTo(x,12); sctx.stroke();
      sctx.fillStyle = sctx.strokeStyle;
      sctx.fillText(String(c.id), x+2, 10);
    }
    updateChannels(d.channels);
  }
  if (wf.height > 1) {
    const img = wctx.getImageData(0,0,wf.width,wf.height-1);
    wctx.putImageData(img,0,1);
  }
  const row = wctx.createImageData(wf.width,1);
  for(let x=0;x<wf.width;x++){
    const v=(pxDb(d,x)-mindb)/(maxdb-mindb);
    const [r,g,b]=palColor(v);
    row.data[4*x]=r; row.data[4*x+1]=g; row.data[4*x+2]=b; row.data[4*x+3]=255;
  }
  wctx.putImageData(row,0,0);
  drawProbe(d.probe);
  fcRender();
}
// probe-tap scope (the testbench's spectrum / triggered-time instrument,
// gui/testbench.cpp:583-898): second canvas fed from frame.probe
const probecv = document.getElementById('probecv');
const pctx = probecv.getContext('2d');
function drawProbe(p){
  const bar = document.getElementById('probebar');
  if (!p){ probecv.style.display='none'; bar.style.display='none'; return; }
  probecv.style.display=''; bar.style.display='';
  const W = probecv.width, H = probecv.height;
  pctx.fillStyle='#181818'; pctx.fillRect(0,0,W,H);
  pctx.strokeStyle='#6f6'; pctx.beginPath();
  if (p.view === 'scope'){
    bar.textContent = `probe ${p.tap}${p.channel!=null?` (ch ${p.channel})`:''} — time (fs=${p.sample_rate} Hz)`;
    const rec = p.record;
    if (!rec) { pctx.fillStyle='#888'; pctx.fillText('armed…', 8, 16); return; }
    let m = 1; for (const v of rec) m = Math.max(m, Math.abs(v));
    for (let x=0; x<W; x++){
      const v = rec[Math.floor(x*rec.length/W)];
      const y = H/2 - (v/m)*(H/2-4);
      if (x===0) pctx.moveTo(x,y); else pctx.lineTo(x,y);
    }
  } else {
    bar.textContent = `probe ${p.tap}${p.channel!=null?` (ch ${p.channel})`:''} — spectrum (fs=${p.sample_rate} Hz)`;
    const db = p.db;
    for (let x=0; x<W; x++){
      const v = db[Math.floor(x*db.length/W)];
      const y = (1-(v-mindb)/(maxdb-mindb))*H;
      if (x===0) pctx.moveTo(x,y); else pctx.lineTo(x,y);
    }
  }
  pctx.stroke();
}
// per-digit frequency entry (CFreqCtrl, gui/freqctrl.cpp: per-digit
// wheel/click/keyboard editing, lead-zero dimming, min/max clamp).  Shows
// the ABSOLUTE station frequency rf_center + tune; edits POST /tune with
// the baseband remainder.
const NDIGITS = 10;                      // up to 9.999 999 999 GHz
const fcDiv = document.getElementById('freqctrl');
let fcActive = -1;                       // keyboard-selected digit
function fcValue(){ return Math.round((view.rf_center||0) + view.tune_hz); }
function fcClamp(v){
  const c = view.rf_center||0, half = view.sample_rate/2;
  return Math.max(Math.max(0, c-half), Math.min(c+half, v));
}
function fcSet(v){
  v = fcClamp(v);
  post('/tune', {freq_hz: v - (view.rf_center||0)});
}
function fcRender(){
  const v = fcValue();
  const s = String(Math.max(0, v)).padStart(NDIGITS, '0');
  let msd = s.length - String(Math.max(1, v)).length; // lead-zero boundary
  let html = '';
  for (let i = 0; i < NDIGITS; i++){
    const dim = i < msd && !(fcActive === i);
    const sel = fcActive === i;
    html += `<span class="fcd" data-i="${i}" style="color:${
      dim ? '#444' : '#fc0'};${sel ? 'background:#334;' : ''}padding:0 1px">${
      s[i]}</span>`;
    if ((NDIGITS - 1 - i) % 3 === 0 && i < NDIGITS - 1)
      html += '<span style="color:#666">.</span>';
  }
  fcDiv.innerHTML = html + '<span style="font-size:14px;color:#888"> Hz</span>';
}
fcDiv.addEventListener('wheel', ev => {
  ev.preventDefault();
  const t = ev.target.closest('.fcd'); if (!t) return;
  const step = Math.pow(10, NDIGITS - 1 - (+t.dataset.i));
  fcSet(fcValue() + (ev.deltaY < 0 ? step : -step));
}, {passive:false});
fcDiv.addEventListener('mousedown', ev => {
  const t = ev.target.closest('.fcd'); if (!t) return;
  const r = t.getBoundingClientRect();
  const step = Math.pow(10, NDIGITS - 1 - (+t.dataset.i));
  // click upper half increments, lower half decrements (freqctrl.cpp)
  fcSet(fcValue() + ((ev.clientY - r.top) < r.height/2 ? step : -step));
  fcActive = +t.dataset.i; fcRender();
});
window.addEventListener('keydown', ev => {
  if (fcActive < 0) return;
  if (ev.key >= '0' && ev.key <= '9'){
    const step = Math.pow(10, NDIGITS - 1 - fcActive);
    const v = fcValue();
    const cur = Math.floor(v / step) % 10;
    fcSet(v + (Number(ev.key) - cur) * step);
    fcActive = Math.min(NDIGITS - 1, fcActive + 1); fcRender();
  } else if (ev.key === 'ArrowLeft'){ fcActive = Math.max(0, fcActive-1); fcRender(); }
  else if (ev.key === 'ArrowRight'){ fcActive = Math.min(NDIGITS-1, fcActive+1); fcRender(); }
  else if (ev.key === 'Escape'){ fcActive = -1; fcRender(); }
});
// browser audio: the rate-locked queue as a streaming WAV (reference:
// always-on soundcard audio, interface/soundout.cpp:86-133)
let audioEl = null;
document.getElementById('audio').onclick = () => {
  const btn = document.getElementById('audio');
  if (audioEl){ audioEl.pause(); audioEl.src=''; audioEl = null;
    btn.innerHTML = '&#128266; audio'; return; }
  audioEl = new Audio('/audio.wav?ts=' + Date.now());
  audioEl.play();
  btn.innerHTML = '&#9209; audio';
};
document.getElementById('vol').onchange = e =>
  post('/volume', {volume: +e.target.value});
document.getElementById('probe').onchange = e =>
  post('/probe', {tap: e.target.value,
                  view: document.getElementById('probeview').value});
document.getElementById('probeview').onchange = e => {
  const tap = document.getElementById('probe').value;
  if (tap !== 'off') post('/probe', {tap, view: e.target.value});
};
// channel table with persistent rows so the per-channel mini-waterfalls
// scroll instead of being rebuilt every frame
const chRows = new Map();
function updateChannels(chs){
  const tbl = document.getElementById('chlist');
  const ids = chs.map(c=>c.id).join();
  if (tbl.dataset.ids !== ids){
    tbl.dataset.ids = ids; chRows.clear();
    tbl.innerHTML = '<tr><th>ch</th><th>freq kHz</th><th>S dB</th>'+
      '<th>audio</th></tr>';
    for (const c of chs){
      const tr = document.createElement('tr');
      tr.style.cursor = 'pointer';
      tr.innerHTML = '<td></td><td></td><td></td>'+
        '<td><canvas width="96" height="24"></canvas></td>';
      tr.onclick = () => post('/select', {channel:c.id});
      tbl.appendChild(tr);
      chRows.set(c.id, tr);
    }
  }
  for (const c of chs){
    const tr = chRows.get(c.id); if (!tr) continue;
    tr.style.color = c.monitor ? '#fc0' : '';
    tr.children[0].textContent = c.id + (c.monitor ? ' ♪' : '');
    tr.children[1].textContent = (c.tune_hz/1e3).toFixed(3);
    tr.children[2].textContent = c.smeter_db.toFixed(1);
    if (!c.spec) continue;
    const cv = tr.querySelector('canvas'), g = cv.getContext('2d');
    const img = g.getImageData(0, 0, cv.width, cv.height-1);
    g.putImageData(img, 0, 1);                    // scroll mini-waterfall
    const row = g.createImageData(cv.width, 1);
    for (let x = 0; x < cv.width; x++){
      const v = (c.spec[Math.floor(x*c.spec.length/cv.width)] + 100) / 100;
      const [r, gg, b] = palColor(v);
      row.data[4*x]=r; row.data[4*x+1]=gg; row.data[4*x+2]=b;
      row.data[4*x+3]=255;
    }
    g.putImageData(row, 0, 0);
  }
}
// control wiring
function applySplit(){
  spec.height = Math.max(1, Math.round(TOTAL_H*pct2d/100));
  wf.height = TOTAL_H - spec.height;
  if (lastFrame) drawFrame(lastFrame);
}
function fixRange(movedMax){   // keep a sane span: degenerate range = NaN y
  if (maxdb - mindb < 5) {
    if (movedMax) mindb = maxdb - 5; else maxdb = mindb + 5;
    document.getElementById('maxdb').value = maxdb;
    document.getElementById('mindb').value = mindb;
  }
}
document.getElementById('maxdb').onchange = e => {
  maxdb = +e.target.value; fixRange(true);
  if (lastFrame) drawFrame(lastFrame); };
document.getElementById('mindb').onchange = e => {
  mindb = +e.target.value; fixRange(false);
  if (lastFrame) drawFrame(lastFrame); };
document.getElementById('zoom').onchange = e => {
  zoom = +e.target.value; if (lastFrame) drawFrame(lastFrame); };
document.getElementById('pal').onchange = e => {
  palette = makePalette(e.target.value);
  if (lastFrame) drawFrame(lastFrame); };
document.getElementById('split').oninput = e => {
  pct2d = +e.target.value; applySplit(); };
applySplit();
// demod mode selector (the demod-setup dialog's radio buttons); shown only
// when the server exposes a mode (single-receiver sessions)
const modeSel = document.getElementById('mode');
modeSel.onchange = e => post('/mode', {mode: e.target.value});
function syncMode(d){
  if (!d.mode) return;
  modeSel.style.display = '';
  if (document.activeElement !== modeSel) modeSel.value = d.mode;
}
// --- push channel (SSE), with poll fallback ---
let gotFirst = false;
function connect(){
  const es = new EventSource('/events');
  es.onmessage = ev => {
    const d = JSON.parse(ev.data);
    if (!gotFirst){       // adopt the server's configured dB range once
      gotFirst = true;
      maxdb = d.max_db; mindb = d.min_db;
      document.getElementById('maxdb').value = maxdb;
      document.getElementById('mindb').value = mindb;
    }
    drawFrame(d);
  };
  es.onerror = () => { es.close();
    document.getElementById('status').textContent='reconnecting…';
    setTimeout(connect, 1000); };
}
connect();
// --- interactions: drag edges / drag center / click-to-tune ---
let drag = null, lastPost = 0;
const HIT = 6; // px
function hitTest(x){
  if (Math.abs(x - fx(view.tune_hz + view.low_hz)) < HIT) return 'low';
  if (Math.abs(x - fx(view.tune_hz + view.hi_hz)) < HIT) return 'hi';
  if (Math.abs(x - fx(view.tune_hz)) < HIT) return 'center';
  return null;
}
let postTimer = null, postQueued = null;
async function post(path, body){
  const now = Date.now();
  if (now - lastPost < 50) {            // throttle drag updates, but keep
    postQueued = [path, body];          // the trailing one so the final
    if (!postTimer)                     // position always lands
      postTimer = setTimeout(() => {
        postTimer = null;
        const q = postQueued; postQueued = null;
        if (q) post(q[0], q[1]);
      }, 60);
    return;
  }
  lastPost = now;
  const r = await fetch(path, {method:'POST', body: JSON.stringify(body)});
  if (r.status === 200) { const d = await r.json(); Object.assign(view, d); }
}
spec.addEventListener('mousemove', ev=>{
  const h = drag || hitTest(ev.offsetX);
  spec.style.cursor = h ? (h==='center'?'grab':'col-resize') : 'crosshair';
  if (!drag) return;
  const f = xf(ev.offsetX);
  if (drag === 'center') post('/tune', {freq_hz: f});
  else if (drag === 'low') {
    let lo = f - view.tune_hz;
    post('/filter', {low_hz: lo, hi_hz: view.symmetric ? -lo : view.hi_hz});
  } else {
    let hi = f - view.tune_hz;
    post('/filter', {low_hz: view.symmetric ? -hi : view.low_hz, hi_hz: hi});
  }
});
spec.addEventListener('mousedown', ev=>{ drag = hitTest(ev.offsetX); });
window.addEventListener('mouseup', ev=>{
  if (drag === null && ev.target === spec)
    post('/tune', {freq_hz: xf(ev.offsetX)});
  drag = null;
});
// wheel tuning (gui/plotter.cpp wheelEvent): one click-resolution step per
// notch, x10 with shift.  Steps accumulate into wheelTarget so rapid
// notches within one display frame each count (view.tune_hz only updates
// per SSE frame); the target resets when a frame confirms the tune.
let wheelTarget = null;
for (const cv of [spec, wf]) cv.addEventListener('wheel', ev=>{
  ev.preventDefault();
  const res = view.click_res || 100;
  const step = res * (ev.shiftKey ? 10 : 1) * (ev.deltaY < 0 ? 1 : -1);
  wheelTarget = (wheelTarget ?? view.tune_hz) + step;
  post('/tune', {freq_hz: wheelTarget});
}, {passive:false});
</script></body></html>"""


class _AudioTee:
    """Fan-out distributor for /audio.wav listeners.

    One wall-clock-paced puller thread consumes the rate-locked queue in
    100 ms chunks (so the queue sees exactly ONE consumer regardless of
    listener count — the queue-depth rate-lock P loop stays meaningful)
    and appends to a small sequence-numbered ring; each HTTP connection
    follows the ring at its own pace.  The puller starts with the first
    listener and stops with the last, so audio is only drained while
    someone is listening (same as the single-listener behavior)."""

    RING = 32                       # ~3.2 s of chunks

    def __init__(self, queue, rate: int):
        self._q = queue
        self._rate = int(rate)
        self._ring: dict[int, bytes] = {}
        self._seq = 0
        self._listeners = 0
        self._cond = threading.Condition()
        self._thread = None
        self._stop = False

    def _run(self):
        chunk = self._rate // 10
        t_next = time.monotonic()
        while True:
            with self._cond:
                if self._stop or self._listeners == 0:
                    self._thread = None
                    return
            t_next += chunk / self._rate
            dt = t_next - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            else:
                t_next = time.monotonic()
            pcm = np.ascontiguousarray(self._q.get(chunk),
                                       np.int16).tobytes()
            with self._cond:
                self._ring[self._seq] = pcm
                self._ring.pop(self._seq - self.RING, None)
                self._seq += 1
                self._cond.notify_all()

    def subscribe(self) -> int:
        with self._cond:
            self._listeners += 1
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                daemon=True,
                                                name="serve-audio-tee")
                self._thread.start()
            return self._seq

    def unsubscribe(self) -> None:
        with self._cond:
            self._listeners -= 1
            self._cond.notify_all()

    def next_chunk(self, seq: int, timeout: float = 1.0):
        """(pcm, next_seq) — skips ahead if the caller fell off the ring."""
        with self._cond:
            self._cond.wait_for(lambda: self._seq > seq or self._stop,
                                timeout=timeout)
            if self._seq <= seq:
                return None, seq
            seq = max(seq, self._seq - self.RING)
            return self._ring.get(seq), seq + 1

    def shutdown(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()


class SpectrumServer:
    """Serves the page + spectrum frames; callbacks wire into a session.

    * ``update(db, smeter_db)`` publishes a frame: stored for /spectrum.json
      and pushed to every open /events (SSE) stream.
    * ``set_view(tune_hz=, low_hz=, hi_hz=, symmetric=)`` keeps the demod
      overlay in sync; POST /tune and /filter update it from the callbacks'
      return values (rounded / clamped by the session).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 sample_rate: float = 2e6, min_db: float = -120.0,
                 max_db: float = 0.0, on_tune=None, on_filter=None,
                 on_select=None, on_mode=None, on_probe=None,
                 on_volume=None, audio_queue=None, audio_rate: int = 48000,
                 audio_stereo: bool = False):
        self._db = np.full(1024, min_db, np.float32)
        self._smeter = None
        self._overload = False
        self._channels: list[dict] = []
        self._probe: dict | None = None
        self.on_select = on_select
        self.on_probe = on_probe
        self.on_volume = on_volume
        self.audio_queue = audio_queue
        self._audio_tee = (_AudioTee(audio_queue, int(audio_rate))
                           if audio_queue is not None else None)
        self.audio_rate = int(audio_rate)
        self.audio_stereo = bool(audio_stereo)
        self._cond = threading.Condition()
        self._seq = 0
        self._stopping = False
        self.sample_rate = sample_rate
        self.min_db, self.max_db = min_db, max_db
        self.on_tune = on_tune
        self.on_filter = on_filter
        self.on_mode = on_mode
        self.view = {"tune_hz": 0.0, "low_hz": -5000.0, "hi_hz": 5000.0,
                     "symmetric": False}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif self.path == "/spectrum.json":
                    with outer._cond:
                        body = outer._frame_json()
                    self._send(body, "application/json")
                elif self.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    last = outer._seq - 1   # send the current frame at once
                    try:
                        while not outer._stopping:
                            with outer._cond:
                                outer._cond.wait_for(
                                    lambda: outer._seq != last
                                    or outer._stopping, timeout=1.0)
                                fresh = outer._seq != last
                                last = outer._seq
                                body = outer._frame_json() if fresh else None
                            if body is None:
                                self.wfile.write(b": keepalive\n\n")
                            else:
                                self.wfile.write(b"data: " + body + b"\n\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        pass
                elif (self.path.startswith("/audio.wav")
                      and outer.audio_queue is not None):
                    # Browser audio: the rate-locked queue streamed as a
                    # never-ending chunked WAV (RIFF sizes 0xFFFFFFFF, the
                    # streaming convention) paced at the soundcard rate —
                    # the reference always plays demodulated audio
                    # (interface/soundout.cpp:86-133); here the browser
                    # replaces the host soundcard as the queue consumer,
                    # so its wall clock drives the same queue-depth
                    # rate-lock P loop.  Volume rides POST /volume
                    # upstream (device-side gain).  Any number of
                    # listeners: a single-consumer tee fans the stream out
                    # (_AudioTee).
                    rate = outer.audio_rate
                    ch = 2 if outer.audio_stereo else 1
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    import struct
                    hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF)
                           + b"WAVEfmt " + struct.pack(
                               "<IHHIIHH", 16, 1, ch, rate,
                               rate * ch * 2, ch * 2, 16)
                           + b"data" + struct.pack("<I", 0xFFFFFFFF))
                    tee = outer._audio_tee
                    seq = tee.subscribe()
                    try:
                        self.wfile.write(hdr)
                        self.wfile.flush()
                        while not outer._stopping:
                            pcm, seq = tee.next_chunk(seq)
                            if pcm is None:
                                continue
                            self.wfile.write(pcm)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        pass
                    finally:
                        tee.unsubscribe()
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or "{}")
                if self.path == "/tune" and outer.on_tune:
                    if "freq_hz" in req:
                        freq = float(req["freq_hz"])
                    else:   # legacy 0..1 fraction of the displayed span
                        freq = ((float(req.get("fraction", 0.5)) - 0.5)
                                * outer.sample_rate)
                    applied = outer.on_tune(freq)
                    if applied is None:
                        applied = freq
                    with outer._cond:
                        outer.view["tune_hz"] = float(applied)
                    self._send(json.dumps({"tune_hz": float(applied)}).encode(),
                               "application/json")
                elif self.path == "/select" and outer.on_select:
                    applied = outer.on_select(int(req.get("channel", 0)))
                    self._send(json.dumps(
                        {"selected": int(applied)}).encode(),
                        "application/json")
                elif self.path == "/mode" and outer.on_mode:
                    applied = outer.on_mode(str(req.get("mode", "usb")))
                    with outer._cond:
                        if applied:
                            outer.view["mode"] = applied
                    self._send(json.dumps({"mode": applied}).encode(),
                               "application/json")
                elif self.path == "/volume" and outer.on_volume:
                    vol = max(0, min(99, int(req.get("volume", 99))))
                    outer.on_volume(vol)
                    self._send(json.dumps({"volume": vol}).encode(),
                               "application/json")
                elif self.path == "/probe" and outer.on_probe:
                    # testbench probe scope (gui/testbench.cpp:583-898):
                    # select a pipeline tap + view; empty/"off" disables
                    try:
                        applied = outer.on_probe(
                            req.get("tap"),
                            str(req.get("view", "spectrum")),
                            str(req.get("trigger_mode", "free")),
                            float(req.get("trigger_level", 0.0)))
                    except ValueError as e:
                        self._send(json.dumps(
                            {"error": str(e)}).encode(),
                            "application/json", code=400)
                        return
                    with outer._cond:
                        if applied is None:
                            outer._probe = None
                    self._send(json.dumps({"tap": applied}).encode(),
                               "application/json")
                elif self.path == "/filter" and outer.on_filter:
                    lo = float(req.get("low_hz", outer.view["low_hz"]))
                    hi = float(req.get("hi_hz", outer.view["hi_hz"]))
                    applied = outer.on_filter(lo, hi)
                    if applied is None:
                        applied = (lo, hi)
                    with outer._cond:
                        outer.view["low_hz"] = float(applied[0])
                        outer.view["hi_hz"] = float(applied[1])
                    self._send(json.dumps(
                        {"low_hz": float(applied[0]),
                         "hi_hz": float(applied[1])}).encode(),
                        "application/json")
                else:
                    self.send_response(204)
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def _frame_json(self) -> bytes:
        """Caller holds self._cond."""
        frame = {
            "db": [round(float(v), 1) for v in self._db],
            "sample_rate": self.sample_rate,
            "min_db": self.min_db, "max_db": self.max_db,
            "smeter_db": self._smeter,
            "overload": self._overload,
            **self.view,
        }
        if self._channels:
            frame["channels"] = self._channels
        if self._probe is not None:
            frame["probe"] = self._probe
        return json.dumps(frame).encode()

    def start(self) -> "SpectrumServer":
        self._thread.start()
        return self

    def update(self, db: np.ndarray, smeter_db: float | None = None,
               channels: list[dict] | None = None,
               overload: bool = False,
               probe: dict | None = None) -> None:
        with self._cond:
            self._db = np.asarray(db, np.float32)
            self._smeter = None if smeter_db is None else float(smeter_db)
            self._overload = bool(overload)
            if channels is not None:
                self._channels = channels
            self._probe = probe
            self._seq += 1
            self._cond.notify_all()

    def set_view(self, **kw) -> None:
        with self._cond:
            self.view.update(kw)
            self._seq += 1
            self._cond.notify_all()

    def stop(self) -> None:
        self._stopping = True
        if self._audio_tee is not None:
            self._audio_tee.shutdown()
        with self._cond:
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
