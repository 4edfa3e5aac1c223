"""Embedded admin web UI (reference: weed/admin/'s web dashboard); the
port's copy of seaweedfs_tpu/admin/dashboard.py, markup unchanged, so both
packages serve the same pages (titled "seaweedfs_tpu admin") for the same
state.

One self-contained HTML page — inline CSS/JS, zero external assets —
served at ``/`` by the admin server.  It polls the JSON API
(/status, /tasks, /topology) every few seconds and renders stat tiles
plus tables: cluster topology, per-node volumes/EC shards, the
maintenance queue, and the worker fleet.  Status states always pair a
label with the color (never color alone).
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>seaweedfs_tpu admin</title>
<style>
  :root {
    --bg: #faf9f5; --surface: #ffffff; --border: #e8e6dc;
    --ink: #1f1e1d; --ink-2: #5e5d59; --ink-3: #91908c;
    --accent: #6a6aa8;
    --good-bg: #e5efe4; --good-ink: #2e5e2a;
    --bad-bg: #f7e4e0; --bad-ink: #8a2e21;
    --warn-bg: #f5ecd7; --warn-ink: #725a18;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      --bg: #262624; --surface: #30302e; --border: #45443f;
      --ink: #f0efea; --ink-2: #b8b7b2; --ink-3: #8a8984;
      --accent: #a8a8d8;
      --good-bg: #2e4230; --good-ink: #a9d1a4;
      --bad-bg: #4a2f2a; --bad-ink: #e9a99d;
      --warn-bg: #463c22; --warn-ink: #dec37a;
    }
  }
  * { box-sizing: border-box; }
  body {
    margin: 0; background: var(--bg); color: var(--ink);
    font: 14px/1.45 system-ui, -apple-system, sans-serif;
  }
  header {
    display: flex; align-items: baseline; gap: 12px;
    padding: 14px 24px; border-bottom: 1px solid var(--border);
  }
  header h1 { font-size: 16px; margin: 0; font-weight: 600; }
  header .sub { color: var(--ink-3); font-size: 12px; }
  main { padding: 20px 24px 48px; max-width: 1100px; margin: 0 auto; }
  .tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 24px; }
  .tile {
    background: var(--surface); border: 1px solid var(--border);
    border-radius: 8px; padding: 12px 16px; min-width: 132px;
  }
  .tile .v { font-size: 24px; font-weight: 600; font-variant-numeric: tabular-nums; }
  .tile .k { color: var(--ink-2); font-size: 12px; margin-top: 2px; }
  h2 { font-size: 13px; font-weight: 600; color: var(--ink-2);
       text-transform: uppercase; letter-spacing: .04em; margin: 28px 0 8px; }
  table {
    width: 100%; border-collapse: collapse; background: var(--surface);
    border: 1px solid var(--border); border-radius: 8px; overflow: hidden;
  }
  th, td { text-align: left; padding: 7px 12px; border-top: 1px solid var(--border);
           font-variant-numeric: tabular-nums; }
  thead th { border-top: 0; color: var(--ink-3); font-size: 12px; font-weight: 500; }
  td.num, th.num { text-align: right; }
  .pill { display: inline-block; padding: 1px 8px; border-radius: 999px;
          font-size: 12px; }
  .pill.ok       { background: var(--good-bg); color: var(--good-ink); }
  .pill.bad      { background: var(--bad-bg);  color: var(--bad-ink); }
  .pill.pending  { background: var(--warn-bg); color: var(--warn-ink); }
  .pill.running  { background: transparent; color: var(--accent);
                   border: 1px solid var(--accent); }
  .muted { color: var(--ink-3); }
  .rowform { display: flex; gap: 8px; margin: 0 0 10px; align-items: center;
             flex-wrap: wrap; }
  .rowform input, .rowform select {
    padding: 6px 8px; border: 1px solid var(--border); border-radius: 6px;
    background: var(--surface); color: var(--ink); }
  .rowform button, td button {
    padding: 5px 10px; border: 0; border-radius: 6px; cursor: pointer;
    background: var(--accent); color: #fff; font-size: 12px; }
  #t-msg { font-size: 12px; color: var(--ink-2); }
  .empty { color: var(--ink-3); padding: 10px 12px; }
  #err { color: var(--bad-ink); background: var(--bad-bg); padding: 6px 12px;
         border-radius: 6px; display: none; margin-bottom: 16px; }
  a { color: var(--accent); }
  footer { margin-top: 36px; color: var(--ink-3); font-size: 12px; }
</style>
</head>
<body>
<header>
  <h1>seaweedfs_tpu admin</h1>
  <span class="sub">maintenance plane &middot; auto-refresh <span id="tick">5s</span></span>
</header>
<main>
  <div id="err"></div>
  <div class="tiles" id="tiles"></div>

  <h2>Topology</h2>
  <div id="topology"></div>

  <h2>Volumes</h2>
  <form id="volctl" class="rowform">
    <select id="v-sort" aria-label="sort">
      <option value="id">sort: id</option>
      <option value="size">sort: size</option>
      <option value="garbage">sort: garbage</option>
      <option value="file_count">sort: files</option>
      <option value="server">sort: server</option>
      <option value="collection">sort: collection</option>
    </select>
    <select id="v-order" aria-label="order">
      <option value="asc">asc</option>
      <option value="desc">desc</option>
    </select>
    <input id="v-coll" placeholder="collection filter">
    <button type="submit">Apply</button>
    <button type="button" id="v-prev">&laquo; prev</button>
    <button type="button" id="v-next">next &raquo;</button>
    <span id="v-msg" role="status"></span>
  </form>
  <div id="volumes"></div>

  <h2>EC shards</h2>
  <div id="ecshards"></div>
  <span id="e-msg" role="status"></span>

  <h2>Collections</h2>
  <div id="collections"></div>
  <span id="c-msg" role="status"></span>

  <h2>S3 buckets</h2>
  <form id="newbucket" class="rowform">
    <input id="b-name" placeholder="bucket name" required>
    <button type="submit">Create bucket</button>
    <span id="b-msg" role="status"></span>
  </form>
  <div id="buckets"></div>

  <h2>Maintenance tasks</h2>
  <form id="newtask" class="rowform">
    <select id="t-kind" aria-label="task kind">
      <option value="ec_encode">ec_encode</option>
      <option value="vacuum">vacuum</option>
      <option value="ttl_delete">ttl_delete</option>
    </select>
    <input id="t-vid" type="number" min="1" placeholder="volume id" required>
    <input id="t-coll" placeholder="collection (optional)">
    <button type="submit">Create task</button>
    <span id="t-msg" role="status"></span>
  </form>
  <div id="tasks"></div>

  <h2>Workers</h2>
  <div id="workers"></div>

  <h2>Files</h2>
  <form id="browse" class="rowform">
    <input id="f-path" value="/" placeholder="/directory" aria-label="path">
    <button type="submit">Browse</button>
    <span id="f-msg" role="status"></span>
  </form>
  <div id="files"></div>

  <h2>Users</h2>
  <form id="newuser" class="rowform">
    <input id="u-name" placeholder="user name" required>
    <button type="submit">Create user</button>
    <span id="u-msg" role="status"></span>
  </form>
  <div id="users"></div>

  <h2>Message queue</h2>
  <div id="mq"></div>

  <h2>IAM policies</h2>
  <div id="policies"></div>

  <footer>
    JSON API: <a href="/status">/status</a> &middot;
    <a href="/tasks">/tasks</a> &middot;
    <a href="/topology">/topology</a> &middot;
    <a href="/volumes">/volumes</a> &middot;
    <a href="/ec/shards">/ec/shards</a> &middot;
    <a href="/collections">/collections</a> &middot;
    <a href="/buckets">/buckets</a> &middot;
    <a href="/files">/files</a> &middot;
    <a href="/users">/users</a>
  </footer>
</main>
<script>
const esc = s => String(s).replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const fmtBytes = n => {
  if (n >= 1<<30) return (n/(1<<30)).toFixed(1) + " GiB";
  if (n >= 1<<20) return (n/(1<<20)).toFixed(1) + " MiB";
  if (n >= 1024)  return (n/1024).toFixed(1) + " KiB";
  return n + " B";
};
const pill = st => {
  const cls = {completed:"ok", failed:"bad", canceled:"bad",
               pending:"pending", assigned:"running"}[st] || "pending";
  return `<span class="pill ${cls}">${esc(st)}</span>`;
};
const tile = (v, k) => `<div class="tile"><div class="v">${esc(v)}</div><div class="k">${esc(k)}</div></div>`;
const table = (heads, rows, empty) => rows.length
  ? `<table><thead><tr>${heads.map(h =>
      `<th class="${h.startsWith("#") ? "num" : ""}">${esc(h.replace(/^#/,""))}</th>`).join("")}
     </tr></thead><tbody>${rows.join("")}</tbody></table>`
  : `<table><tbody><tr><td class="empty">${esc(empty)}</td></tr></tbody></table>`;

async function refresh() {
  try {
    const check = await fetch("/status");
    if (check.status === 401) { location.href = "/login"; return; }
    const [status, tasks, topo] = await Promise.all([
      check.json(),
      fetch("/tasks").then(r => r.json()),
      fetch("/topology").then(r => r.json()),
    ]);
    document.getElementById("err").style.display = "none";

    const counts = status.tasks || {};
    let nVol = 0, nEc = 0, bytes = 0;
    for (const n of topo.nodes || []) {
      nVol += n.volumes.length; nEc += n.ec_volumes.length;
      for (const v of n.volumes) bytes += v.size;
    }
    document.getElementById("tiles").innerHTML =
      tile((topo.nodes || []).length, "volume servers") +
      tile(nVol, "volumes") +
      tile(nEc, "ec volumes") +
      tile(fmtBytes(bytes), "logical bytes") +
      tile(counts.pending || 0, "tasks pending") +
      tile(counts.assigned || 0, "tasks running") +
      tile(Object.keys(status.workers_seen_ago || {}).length, "workers");

    document.getElementById("topology").innerHTML = table(
      ["node", "dc / rack", "#volumes", "#ec shards", "#free slots", "#bytes"],
      (topo.nodes || []).map(n => {
        const shardCount = n.ec_volumes.reduce((a, e) => a + e.shards.length, 0);
        const sz = n.volumes.reduce((a, v) => a + v.size, 0);
        return `<tr><td>${esc(n.id)}</td>
          <td class="muted">${esc(n.dc)} / ${esc(n.rack)}</td>
          <td class="num">${n.volumes.length}</td>
          <td class="num">${shardCount}</td>
          <td class="num">${n.free_slots}</td>
          <td class="num">${fmtBytes(sz)}</td></tr>`;
      }),
      "no volume servers registered");

    document.getElementById("tasks").innerHTML = table(
      ["id", "kind", "volume", "status", "worker", "detail", ""],
      (tasks.tasks || []).slice().reverse().slice(0, 50).map(t =>
        `<tr><td class="muted">${esc(t.id)}</td><td>${esc(t.kind)}</td>
         <td class="num">${esc(t.volume_id)}</td><td>${pill(t.state)}</td>
         <td class="muted">${esc(t.worker_id || "—")}</td>
         <td class="muted">${esc(t.error || "")}</td>
         <td>${t.state === "pending"
             ? `<button data-cancel="${esc(t.id)}">cancel</button>` : ""}</td></tr>`),
      "queue is empty — the scanner found nothing to do");

    const workers = Object.entries(status.workers_seen_ago || {});
    document.getElementById("workers").innerHTML = table(
      ["worker", "#last seen"],
      workers.map(([w, ago]) =>
        `<tr><td>${esc(w)}</td><td class="num">${ago}s ago</td></tr>`),
      "no workers have claimed tasks yet");
  } catch (e) {
    const el = document.getElementById("err");
    el.textContent = "refresh failed: " + e;
    el.style.display = "block";
  }
}
// one DELEGATED cancel listener: innerHTML swaps on refresh would
// discard per-button bindings
document.getElementById("tasks").addEventListener("click", async e => {
  const id = e.target?.dataset?.cancel;
  if (!id) return;
  const msg = document.getElementById("t-msg");
  try {
    const resp = await fetch("/tasks/cancel", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({task_id: Number(id)}),
    });
    const body = await resp.json();
    msg.textContent = resp.ok
      ? `canceled task ${id}` : `cancel failed: ${body.error}`;
  } catch (err) {
    msg.textContent = `cancel failed: ${err}`;
  }
  refresh();
});
document.getElementById("newtask").addEventListener("submit", async e => {
  e.preventDefault();
  const msg = document.getElementById("t-msg");
  try {
    const resp = await fetch("/tasks/create", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({
        kind: document.getElementById("t-kind").value,
        volume_id: Number(document.getElementById("t-vid").value),
        collection: document.getElementById("t-coll").value,
      }),
    });
    const body = await resp.json();
    msg.textContent = resp.ok
      ? `created task ${body.task.id}` : `error: ${body.error}`;
  } catch (err) {
    msg.textContent = `create failed: ${err}`;
  }
  refresh();
});
// ---- file browser (503 until the admin is started with -filer) ----
async function browse(path) {
  const msg = document.getElementById("f-msg");
  const el = document.getElementById("files");
  try {
    const resp = await fetch("/files?path=" + encodeURIComponent(path));
    const body = await resp.json();
    if (!resp.ok) { msg.textContent = body.error; el.innerHTML = ""; return; }
    msg.textContent = body.truncated ? "(truncated page)" : "";
    el.innerHTML = table(
      ["name", "size", "collection", ""],
      body.entries.map(e => [
        e.is_directory
          ? `<a href="#" data-dir="${esc(body.path.replace(/\\/$/,""))}/${esc(e.name)}">${esc(e.name)}/</a>`
          : esc(e.name),
        `<span class="num">${e.is_directory ? "—" : fmtBytes(e.size)}</span>`,
        esc(e.collection || ""),
        `<button data-del="${esc(body.path.replace(/\\/$/,""))}/${esc(e.name)}"
                 data-rec="${e.is_directory}">delete</button>`,
      ]),
      "empty directory");
  } catch (err) { msg.textContent = "browse failed: " + err; }
}
document.getElementById("browse").addEventListener("submit", e => {
  e.preventDefault();
  browse(document.getElementById("f-path").value || "/");
});
document.getElementById("files").addEventListener("click", async e => {
  const dir = e.target?.dataset?.dir;
  if (dir) {
    e.preventDefault();
    document.getElementById("f-path").value = dir;
    browse(dir);
    return;
  }
  const del = e.target?.dataset?.del;
  if (!del) return;
  const resp = await fetch("/files/delete", {
    method: "POST", headers: {"Content-Type": "application/json"},
    body: JSON.stringify({path: del, recursive: e.target.dataset.rec === "true"}),
  });
  const body = await resp.json();
  document.getElementById("f-msg").textContent =
    resp.ok ? `deleted ${del}` : `delete failed: ${body.error}`;
  browse(document.getElementById("f-path").value || "/");
});

// ---- user management ----
async function loadUsers() {
  const el = document.getElementById("users");
  try {
    const resp = await fetch("/users");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    el.innerHTML = table(
      ["name", "actions", "access keys", ""],
      body.users.map(u => [
        esc(u.name),
        esc(u.actions.join(", ")),
        u.access_keys.map(k =>
          `<code>${esc(k)}</code> <button data-delkey="${esc(u.name)}|${esc(k)}">revoke</button>`
        ).join("<br>") || "—",
        `<button data-newkey="${esc(u.name)}">new key</button>
         <button data-deluser="${esc(u.name)}">delete user</button>`,
      ]),
      "no users configured");
  } catch (err) { el.innerHTML = `<p>users failed: ${esc(err)}</p>`; }
}
document.getElementById("newuser").addEventListener("submit", async e => {
  e.preventDefault();
  const msg = document.getElementById("u-msg");
  const resp = await fetch("/users/create", {
    method: "POST", headers: {"Content-Type": "application/json"},
    body: JSON.stringify({name: document.getElementById("u-name").value}),
  });
  const body = await resp.json();
  msg.textContent = resp.ok ? `created ${body.name}` : `error: ${body.error}`;
  loadUsers();
});
document.getElementById("users").addEventListener("click", async e => {
  const msg = document.getElementById("u-msg");
  if (e.target?.dataset?.newkey) {
    const [ok, body] = await post("/users/keys/create",
                                  {name: e.target.dataset.newkey});
    msg.textContent = ok
      ? `key ${body.access_key} secret ${body.secret_key} (copy it NOW)`
      : `error: ${body.error}`;
  } else if (e.target?.dataset?.delkey) {
    const [name, key] = e.target.dataset.delkey.split("|");
    const [ok, body] = await post("/users/keys/delete",
                                  {name, access_key: key});
    msg.textContent = ok ? `revoked ${key}` : `error: ${body.error}`;
  } else if (e.target?.dataset?.deluser) {
    const [ok, body] = await post("/users/delete",
                                  {name: e.target.dataset.deluser});
    msg.textContent = ok ? "user deleted" : `error: ${body.error}`;
  } else return;
  loadUsers();
});
loadUsers();

// ---- volume / EC / collection / bucket management ----
const post = async (url, payload) => {
  const resp = await fetch(url, {
    method: "POST", headers: {"Content-Type": "application/json"},
    body: JSON.stringify(payload),
  });
  return [resp.ok, await resp.json()];
};
let volPage = 1;
async function loadVolumes() {
  const msg = document.getElementById("v-msg");
  const el = document.getElementById("volumes");
  try {
    const sort = document.getElementById("v-sort").value;
    const order = document.getElementById("v-order").value;
    const coll = document.getElementById("v-coll").value;
    const qs = `sort=${sort}&order=${order}&page=${volPage}&pageSize=25` +
               (coll ? `&collection=${encodeURIComponent(coll)}` : "");
    const resp = await fetch("/volumes?" + qs);
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    const pages = Math.max(1, Math.ceil(body.total / body.page_size));
    if (volPage > pages) { volPage = pages; return loadVolumes(); }
    msg.textContent = `${body.total} rows, page ${body.page}/${pages}`;
    el.innerHTML = table(
      ["#id", "server", "collection", "#size", "#files", "#garbage",
       "repl", "state", ""],
      body.volumes.map(v =>
        `<tr><td class="num">${v.id}</td><td>${esc(v.server)}</td>
         <td>${esc(v.collection) || '<span class="muted">default</span>'}</td>
         <td class="num">${fmtBytes(v.size)}</td>
         <td class="num">${v.file_count}</td>
         <td class="num">${(v.garbage_ratio * 100).toFixed(1)}%</td>
         <td>${esc(v.replication)}</td>
         <td>${v.read_only ? '<span class="pill pending">readonly</span>'
                           : '<span class="pill ok">writable</span>'}</td>
         <td><button data-vvac="${v.id}">vacuum</button>
             <button data-vunmount="${v.id}|${esc(v.server)}">unmount</button>
             <button data-vmove="${v.id}|${esc(v.server)}">move</button>
         </td></tr>`),
      "no volumes in the topology");
  } catch (err) { el.innerHTML = `<p>volumes failed: ${esc(err)}</p>`; }
}
document.getElementById("volctl").addEventListener("submit", e => {
  e.preventDefault(); volPage = 1; loadVolumes();
});
document.getElementById("v-prev").addEventListener("click", () => {
  if (volPage > 1) { volPage--; loadVolumes(); }
});
document.getElementById("v-next").addEventListener("click", () => {
  volPage++; loadVolumes();
});
document.getElementById("volumes").addEventListener("click", async e => {
  const msg = document.getElementById("v-msg");
  if (e.target?.dataset?.vvac) {
    const [ok, body] = await post("/volumes/vacuum",
                                  {volume_id: Number(e.target.dataset.vvac)});
    msg.textContent = ok
      ? `vacuumed: ${JSON.stringify(body.reclaimed_bytes)}`
      : `vacuum failed: ${body.error}`;
  } else if (e.target?.dataset?.vunmount) {
    const [vid, server] = e.target.dataset.vunmount.split("|");
    const [ok, body] = await post("/volumes/unmount",
                                  {volume_id: Number(vid), server});
    msg.textContent = ok ? `unmounted ${vid} on ${server}`
                         : `unmount failed: ${body.error}`;
  } else if (e.target?.dataset?.vmove) {
    const [vid, source] = e.target.dataset.vmove.split("|");
    const target = prompt(`Move volume ${vid} from ${source} to server:`);
    if (!target) return;
    const [ok, body] = await post("/volumes/move",
      {volume_id: Number(vid), source, target});
    msg.textContent = ok ? `moved ${vid} to ${target}`
                         : `move failed: ${body.error}`;
  } else return;
  loadVolumes();
});
async function loadEcShards() {
  const el = document.getElementById("ecshards");
  try {
    const resp = await fetch("/ec/shards");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    el.innerHTML = table(
      ["#volume", "collection", "#size", "placement", "missing", ""],
      body.ec_volumes.map(v => {
        const placement = Object.entries(v.shards)
          .map(([sid, servers]) => `${sid}:${servers.map(esc).join("+")}`)
          .join(" ");
        return `<tr><td class="num">${v.id}</td>
          <td>${esc(v.collection) || '<span class="muted">default</span>'}</td>
          <td class="num">${fmtBytes(v.size)}</td>
          <td class="muted">${placement}</td>
          <td>${v.missing.length
              ? `<span class="pill bad">${v.missing.join(",")}</span>`
              : '<span class="pill ok">complete</span>'}</td>
          <td><button data-ecrebuild="${v.id}">rebuild</button></td></tr>`;
      }),
      "no EC volumes");
  } catch (err) { el.innerHTML = `<p>ec failed: ${esc(err)}</p>`; }
}
document.getElementById("ecshards").addEventListener("click", async e => {
  const vid = e.target?.dataset?.ecrebuild;
  if (!vid) return;
  const [ok, body] = await post("/ec/rebuild", {volume_id: Number(vid)});
  document.getElementById("e-msg").textContent = ok
    ? `rebuilt shards [${body.rebuilt_shard_ids}] on ${body.server}`
    : `rebuild failed: ${body.error}`;
  loadEcShards();
});
async function loadCollections() {
  const el = document.getElementById("collections");
  try {
    const resp = await fetch("/collections");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    el.innerHTML = table(
      ["name", "#volumes", "#ec volumes", "#size", "#files", ""],
      body.collections.map(c =>
        `<tr><td>${esc(c.name) || '<span class="muted">default</span>'}</td>
         <td class="num">${c.volumes}</td>
         <td class="num">${c.ec_volumes}</td>
         <td class="num">${fmtBytes(c.size)}</td>
         <td class="num">${c.file_count}</td>
         <td>${c.name
             ? `<button data-cdel="${esc(c.name)}">delete</button>` : ""}
         </td></tr>`),
      "no collections");
  } catch (err) { el.innerHTML = `<p>collections failed: ${esc(err)}</p>`; }
}
document.getElementById("collections").addEventListener("click", async e => {
  const name = e.target?.dataset?.cdel;
  if (!name) return;
  if (!confirm(`Delete collection ${name} and ALL its volumes?`)) return;
  const [ok, body] = await post("/collections/delete", {name});
  document.getElementById("c-msg").textContent = ok
    ? `deleted ${body.deleted_volumes} volumes, ${body.deleted_ec_shards} EC shards`
    : `delete failed: ${body.error}`;
  loadCollections(); loadVolumes();
});
async function loadBuckets() {
  const el = document.getElementById("buckets");
  try {
    const resp = await fetch("/buckets");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    el.innerHTML = table(
      ["name", "#size", "#volumes", "quota", ""],
      body.buckets.map(b =>
        `<tr><td>${esc(b.name)}</td>
         <td class="num">${fmtBytes(b.size)}</td>
         <td class="num">${b.volumes}</td>
         <td>${b.quota_bytes ? fmtBytes(b.quota_bytes) : "—"}
             ${b.quota_frozen ? '<span class="pill bad">frozen</span>' : ""}</td>
         <td><button data-bquota="${esc(b.name)}">quota</button>
             <button data-bdel="${esc(b.name)}">delete</button></td></tr>`),
      "no buckets (or no -filer configured)");
  } catch (err) { el.innerHTML = `<p>buckets failed: ${esc(err)}</p>`; }
}
document.getElementById("newbucket").addEventListener("submit", async e => {
  e.preventDefault();
  const [ok, body] = await post("/buckets/create",
                                {name: document.getElementById("b-name").value});
  document.getElementById("b-msg").textContent =
    ok ? "bucket created" : `create failed: ${body.error}`;
  loadBuckets();
});
document.getElementById("buckets").addEventListener("click", async e => {
  const msg = document.getElementById("b-msg");
  if (e.target?.dataset?.bdel) {
    const name = e.target.dataset.bdel;
    if (!confirm(`Delete bucket ${name} and all its objects?`)) return;
    const [ok, body] = await post("/buckets/delete", {name});
    msg.textContent = ok ? `deleted ${name}` : `delete failed: ${body.error}`;
  } else if (e.target?.dataset?.bquota) {
    const name = e.target.dataset.bquota;
    const mb = prompt(`Quota for ${name} in MB (0 clears):`, "0");
    if (mb === null) return;
    const n = Number(mb);
    if (!Number.isFinite(n) || n < 0) {
      msg.textContent = `"${mb}" is not a number of MB`;
      return;
    }
    const [ok, body] = await post("/buckets/quota",
      {name, quota_bytes: n * 1024 * 1024});
    msg.textContent = ok ? `quota updated` : `quota failed: ${body.error}`;
  } else return;
  loadBuckets();
});
loadVolumes(); loadEcShards(); loadCollections(); loadBuckets();
setInterval(loadEcShards, 15000);

// ---- MQ topics + IAM policies (read views) ----
async function loadMq() {
  const el = document.getElementById("mq");
  try {
    const resp = await fetch("/mq/topics");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    el.innerHTML =
      `<p>${body.brokers.length} broker(s): ${body.brokers.map(esc).join(", ") || "none"}</p>` +
      table(
        ["topic", "partitions", "schema", "owners"],
        body.topics.map(t => [
          `${esc(t.namespace)}/${esc(t.name)}`,
          `<span class="num">${t.partitions}</span>`,
          t.schema ? "yes" : "—",
          esc([...new Set(Object.values(t.owners))].join(", ")),
        ]),
        "no topics configured");
  } catch (err) { el.innerHTML = `<p>mq failed: ${esc(err)}</p>`; }
}
async function loadPolicies() {
  const el = document.getElementById("policies");
  try {
    const resp = await fetch("/policies");
    const body = await resp.json();
    if (!resp.ok) { el.innerHTML = `<p>${esc(body.error)}</p>`; return; }
    const names = Object.keys(body.policies);
    el.innerHTML = table(
      ["name", "statements"],
      names.map(n => [
        esc(n),
        `<span class="num">${(body.policies[n].Statement || []).length}</span>`,
      ]),
      "no named policies");
  } catch (err) { el.innerHTML = `<p>policies failed: ${esc(err)}</p>`; }
}
loadMq();
loadPolicies();
setInterval(loadMq, 15000);

refresh();
setInterval(refresh, 5000);
</script>
</body>
</html>
"""

LOGIN_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>seaweedfs_tpu admin — sign in</title>
<style>
  :root { --bg:#faf9f5; --surface:#fff; --border:#e8e6dc; --ink:#1f1e1d;
          --ink-2:#5e5d59; --accent:#6a6aa8; --bad:#8a2e21; }
  @media (prefers-color-scheme: dark) {
    :root { --bg:#262624; --surface:#30302e; --border:#45443f;
            --ink:#f0efea; --ink-2:#b8b7b2; --accent:#a8a8d8; --bad:#e9a99d; }
  }
  body { margin:0; background:var(--bg); color:var(--ink);
         font:14px/1.45 system-ui,-apple-system,sans-serif;
         display:grid; place-items:center; min-height:100vh; }
  form { background:var(--surface); border:1px solid var(--border);
         border-radius:10px; padding:28px; width:300px; }
  h1 { font-size:16px; margin:0 0 16px; }
  label { display:block; color:var(--ink-2); font-size:12px; margin:10px 0 4px; }
  input { width:100%; box-sizing:border-box; padding:8px;
          border:1px solid var(--border); border-radius:6px;
          background:var(--bg); color:var(--ink); }
  button { margin-top:16px; width:100%; padding:9px; border:0;
           border-radius:6px; background:var(--accent); color:#fff;
           font-weight:600; cursor:pointer; }
  #err { color:var(--bad); font-size:12px; margin-top:10px; display:none; }
</style>
</head>
<body>
<form id="f">
  <h1>seaweedfs_tpu admin</h1>
  <label for="u">username</label><input id="u" autocomplete="username">
  <label for="p">password</label>
  <input id="p" type="password" autocomplete="current-password">
  <button type="submit">Sign in</button>
  <div id="err" role="alert">invalid credentials</div>
</form>
<script>
document.getElementById("f").addEventListener("submit", async e => {
  e.preventDefault();
  const resp = await fetch("/login", {
    method: "POST", headers: {"Content-Type": "application/json"},
    body: JSON.stringify({
      username: document.getElementById("u").value,
      password: document.getElementById("p").value,
    }),
  });
  if (resp.ok) location.href = "/";
  else document.getElementById("err").style.display = "block";
});
</script>
</body>
</html>
"""
