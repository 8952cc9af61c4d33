"""Operator UI: a self-contained dashboard page + the PBS index-injection
utility.

Reference: internal/server/web/js_compiler.go:36-366 + views/ — the
reference compiles JS panels (views/pre/* then views/custom/*) and
injects them into the stock PBS ``index.hbs`` between marker comments,
re-injecting on file change.  Here:

- :func:`compile_panels` — same two-stage concatenation over a views dir
  (operators drop ``*.js`` files in ``views/pre`` / ``views/custom``);
- :func:`inject_into_index` — idempotent marker-delimited injection into
  a PBS index template (the drop-in-sidecar-on-a-PBS-host deployment);
- ``DASHBOARD_HTML`` — a dependency-free single-page UI served at
  ``/plus/ui`` against this server's own API for PBS-less deployments.

A copy of the JAX package's ``server/ui.py``, its code byte for byte.
"""

from __future__ import annotations

import os

from ..utils import atomicio

MARK_BEGIN = "<!-- pbs-plus-tpu:begin -->"
MARK_END = "<!-- pbs-plus-tpu:end -->"


def compile_panels(views_dir: str) -> str:
    """Concatenate panel JS: ``pre/*.js`` first, then ``custom/*.js``,
    each stage sorted by filename (reference: js_compiler two-stage
    compile).  Missing dirs are fine."""
    parts: list[str] = []
    for stage in ("pre", "custom"):
        d = os.path.join(views_dir, stage)
        try:
            names = sorted(n for n in os.listdir(d) if n.endswith(".js"))
        except OSError:
            continue
        for n in names:
            with open(os.path.join(d, n)) as f:
                parts.append(f"// -- {stage}/{n}\n{f.read().rstrip()}\n")
    return "\n".join(parts)


def inject_into_index(index_path: str, script: str) -> bool:
    """Idempotently (re)place a marker-delimited <script> block before
    </body> in a PBS index template.  Returns True when the file
    changed."""
    with open(index_path) as f:
        html = f.read()
    block = f"{MARK_BEGIN}\n<script>\n{script}\n</script>\n{MARK_END}"
    if MARK_BEGIN in html and MARK_END in html:
        pre, _, rest = html.partition(MARK_BEGIN)
        _, _, post = rest.partition(MARK_END)
        new = pre + block + post
    elif "</body>" in html:
        new = html.replace("</body>", block + "\n</body>", 1)
    else:
        new = html + "\n" + block + "\n"
    if new == html:
        return False
    atomicio.replace_bytes(index_path, new.encode("utf-8"))
    return True


DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>PBS Plus TPU</title>
<style>
 body{font:14px/1.4 system-ui,sans-serif;margin:0;background:#f4f5f7;color:#222}
 header{background:#1d2633;color:#fff;padding:10px 18px;display:flex;gap:14px;
        align-items:baseline}
 header h1{font-size:17px;margin:0} header span{opacity:.7;font-size:12px}
 main{padding:14px 18px;display:grid;gap:16px;
      grid-template-columns:repeat(auto-fit,minmax(420px,1fr))}
 section{background:#fff;border-radius:8px;padding:12px 14px;
         box-shadow:0 1px 3px rgba(0,0,0,.12)}
 h2{font-size:13px;text-transform:uppercase;letter-spacing:.06em;
    color:#556;margin:0 0 8px}
 table{border-collapse:collapse;width:100%;font-size:13px}
 td,th{padding:4px 8px;border-bottom:1px solid #eef0f3;text-align:left}
 th{color:#667;font-weight:600}
 .ok{color:#1a7f37}.err{color:#b42318}.warn{color:#9a6700}
 button{border:1px solid #c9ced6;background:#fff;border-radius:5px;
        padding:2px 9px;cursor:pointer;font-size:12px}
 button:hover{background:#eef2f7}
 #token-bar{margin-left:auto}
 #token-bar input{border:0;border-radius:4px;padding:3px 8px;width:230px}
 .muted{color:#99a}
</style></head><body>
<header><h1>PBS Plus <b>TPU</b></h1><span>operator dashboard</span>
<div id="token-bar"><input id="token" placeholder="api token id:secret"
 onchange="saveToken()"></div></header>
<main>
 <section><h2>Backup jobs</h2><table id="jobs"></table></section>
 <section><h2>Snapshots</h2><table id="snaps"></table></section>
 <section><h2>Tasks</h2><table id="tasks"></table></section>
 <section><h2>Agents &amp; targets</h2><table id="targets"></table></section>
 <section><h2>Mounts</h2><table id="mounts"></table></section>
 <section><h2>Restores</h2><table id="restores"></table></section>
</main>
<script>
const $=id=>document.getElementById(id);
function saveToken(){localStorage.setItem('pbs_token',$('token').value);load()}
$('token').value=localStorage.getItem('pbs_token')||'';
function hdrs(){const t=localStorage.getItem('pbs_token');
 return t?{'Authorization':'Bearer '+t,'Content-Type':'application/json'}:{}}
async function api(path,opts){const r=await fetch(path,
 Object.assign({headers:hdrs()},opts||{}));
 if(!r.ok)throw new Error(path+': '+r.status);return r.json()}
function cls(s){return s==='success'?'ok':(s==='error'?'err':'warn')}
// every API-derived value goes through esc() before innerHTML — target
// hostnames (and anything else a token holder can write) are untrusted
function esc(s){return String(s).replace(/[&<>"']/g,c=>({'&':'&amp;',
 '<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function row(cells){return '<tr>'+cells.map(c=>'<td>'+c+'</td>')
 .join('')+'</tr>'}
async function load(){
 try{
  const jobs=(await api('/api2/json/d2d/backup')).data;
  $('jobs').innerHTML='<tr><th>id</th><th>target</th><th>status</th>'+
   '<th>last snapshot</th><th></th></tr>'+jobs.map(j=>row([esc(j.id),
   esc(j.target),
   `<span class="${cls(j.last_status)}">${esc(j.last_status??'—')}${
      j.running?' ▶':''}</span>`,
   j.last_snapshot!=null?esc(j.last_snapshot):'<span class=muted>—</span>',
   `<button onclick="runJob(decodeURIComponent('${
      encodeURIComponent(j.id)}'))">run</button>`])).join('');
  const snaps=(await api('/api2/json/d2d/snapshots')).data;
  $('snaps').innerHTML='<tr><th>snapshot</th><th></th></tr>'+
   snaps.slice(-15).reverse().map(s=>row([esc(s.snapshot),
   `<button onclick="mountSnap(decodeURIComponent('${
      encodeURIComponent(s.snapshot)}'))">mount</button>`]))
   .join('');
  const tasks=(await api('/api2/json/d2d/tasks')).data;
  $('tasks').innerHTML='<tr><th>task</th><th>kind</th><th>status</th></tr>'+
   tasks.slice(0,12).map(t=>row([esc(t.upid.slice(0,34))+'…',esc(t.kind),
   `<span class="${cls(t.status)}">${esc(t.status)}</span>`])).join('');
  const tg=(await api('/api2/json/d2d/target')).data;
  $('targets').innerHTML='<tr><th>name</th><th>host</th><th>state</th></tr>'+
   tg.map(t=>row([esc(t.name),esc(t.hostname),t.connected?
   '<span class=ok>connected</span>':'<span class=err>offline</span>']))
   .join('');
  const ms=(await api('/api2/json/d2d/mount')).data;
  $('mounts').innerHTML='<tr><th>id</th><th>snapshot</th><th></th></tr>'+
   ms.map(m=>row([esc(m.mount_id),esc(m.snapshot),
   `<button onclick="unmount(decodeURIComponent('${
      encodeURIComponent(m.mount_id)}'))">unmount</button>`]))
   .join('');
  const rs=(await api('/api2/json/d2d/restores')).data;
  $('restores').innerHTML='<tr><th>id</th><th>snapshot</th>'+
   '<th>status</th></tr>'+rs.slice(0,10).map(r=>row([esc(r.id),
   esc(r.snapshot),
   `<span class="${cls(r.status)}">${esc(r.status??'queued')}</span>`]))
   .join('');
 }catch(e){console.error(e)}
}
async function runJob(id){await api(
 `/api2/json/d2d/backup/${encodeURIComponent(id)}/run`,
 {method:'POST'});setTimeout(load,500)}
async function mountSnap(s){await api('/api2/json/d2d/mount',{method:'POST',
 body:JSON.stringify({snapshot:s})});setTimeout(load,500)}
async function unmount(id){await api(
 `/api2/json/d2d/mount/${encodeURIComponent(id)}`,
 {method:'DELETE'});setTimeout(load,500)}
load();setInterval(load,5000);
</script></body></html>
"""
