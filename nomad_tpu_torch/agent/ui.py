"""Embedded web UI.

Port of ``nomad_tpu/agent/ui.py``.

Reference: ui/ (a 389-file Ember app). The tpu-native build ships a
dependency-free single-page app embedded in the agent binary-equivalent:
hash-routed views over the same JSON API the SDK uses (jobs, job detail
with allocs/evals/deployments, nodes + node detail, allocations, evals,
services, CSI plugins, topology, servers), 5s auto-refresh, ACL token
entry stored in localStorage and sent as X-Nomad-Token. Served at /ui by
agent/http.py (GET / redirects there, like the reference).
"""

INDEX_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root {
  --bg: #0f1419; --panel: #161d26; --line: #233041; --fg: #d8e1ea;
  --dim: #8496a8; --accent: #25ba81; --warn: #e0a458; --bad: #e06c75;
  --info: #61afef;
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--bg); color: var(--fg);
  font: 14px/1.5 -apple-system, "Segoe UI", Roboto, sans-serif; }
header { display: flex; align-items: center; gap: 18px;
  padding: 10px 20px; background: var(--panel);
  border-bottom: 1px solid var(--line); position: sticky; top: 0; }
header .logo { font-weight: 700; color: var(--accent);
  letter-spacing: .5px; }
nav a { color: var(--dim); text-decoration: none; margin-right: 14px; }
nav a.active, nav a:hover { color: var(--fg); }
#token { background: var(--bg);
  border: 1px solid var(--line); color: var(--fg); padding: 4px 8px;
  border-radius: 4px; width: 180px; }
#search { margin-left: auto; background: var(--bg);
  border: 1px solid var(--line); color: var(--fg); padding: 4px 8px;
  border-radius: 4px; width: 240px; }
#searchresults { position: fixed; right: 210px; top: 44px; z-index: 10;
  background: var(--panel); border: 1px solid var(--line);
  border-radius: 0 0 6px 6px; max-width: 420px; max-height: 70vh;
  overflow-y: auto; }
#searchresults a { display: block; padding: 5px 12px; }
#searchresults .ctx { color: var(--dim); font-size: 11px;
  text-transform: uppercase; padding: 5px 12px 0; }
main { padding: 20px; max-width: 1200px; margin: 0 auto; }
h1 { font-size: 18px; margin: 0 0 14px; }
h2 { font-size: 15px; margin: 22px 0 8px; color: var(--dim); }
table { width: 100%; border-collapse: collapse; background: var(--panel);
  border: 1px solid var(--line); border-radius: 6px; overflow: hidden; }
th, td { text-align: left; padding: 7px 12px;
  border-bottom: 1px solid var(--line); }
th { color: var(--dim); font-weight: 600; font-size: 12px;
  text-transform: uppercase; letter-spacing: .4px; }
tr:last-child td { border-bottom: none; }
tbody tr:hover { background: #1b2430; }
a { color: var(--info); text-decoration: none; }
a:hover { text-decoration: underline; }
.pill { display: inline-block; padding: 1px 9px; border-radius: 10px;
  font-size: 12px; border: 1px solid var(--line); }
.ok { color: var(--accent); border-color: var(--accent); }
.warn { color: var(--warn); border-color: var(--warn); }
.bad { color: var(--bad); border-color: var(--bad); }
.dim { color: var(--dim); }
.kv { display: grid; grid-template-columns: 220px 1fr; gap: 4px 16px;
  background: var(--panel); border: 1px solid var(--line);
  border-radius: 6px; padding: 12px 16px; }
.kv dt { color: var(--dim); } .kv dd { margin: 0; word-break: break-all; }
#err { color: var(--bad); margin-bottom: 10px; white-space: pre-wrap; }
.bar { display: inline-block; height: 10px; background: var(--accent);
  border-radius: 2px; vertical-align: middle; }
.barbg { display: inline-block; width: 120px; height: 10px;
  background: var(--line); border-radius: 2px; vertical-align: middle; }
code { background: var(--bg); padding: 1px 5px; border-radius: 3px; }
textarea, #xin { width: 100%; background: var(--bg); color: var(--fg);
  border: 1px solid var(--line); border-radius: 6px; padding: 10px;
  font: 13px/1.45 ui-monospace, "SF Mono", Menlo, monospace; }
textarea { min-height: 320px; resize: vertical; }
button { background: var(--accent); color: #08110d; border: none;
  padding: 7px 16px; border-radius: 5px; font-weight: 600;
  cursor: pointer; margin-right: 8px; }
button.alt { background: var(--panel); color: var(--fg);
  border: 1px solid var(--line); }
button.danger { background: var(--bad); color: #140a0b; }
#term { background: #06090d; border: 1px solid var(--line);
  border-radius: 6px; padding: 12px; min-height: 260px; max-height: 420px;
  overflow-y: auto; white-space: pre-wrap; word-break: break-all;
  font: 13px/1.4 ui-monospace, "SF Mono", Menlo, monospace; }
#runout { white-space: pre-wrap; background: var(--panel);
  border: 1px solid var(--line); border-radius: 6px; padding: 12px;
  font: 13px/1.45 ui-monospace, Menlo, monospace; }
</style>
</head>
<body>
<header>
  <span class="logo">nomad-tpu</span>
  <nav id="nav"></nav>
  <input id="search" placeholder="search (jobs, nodes, allocs…)"
    title="prefix search across the cluster">
  <input id="token" placeholder="ACL token" title="X-Nomad-Token">
</header>
<div id="searchresults"></div>
<main>
  <div id="err"></div>
  <div id="view">loading…</div>
</main>
<script>
"use strict";
const $ = (s) => document.querySelector(s);
const NAV = [
  ["jobs", "Jobs"], ["run", "Run"], ["deployments", "Deployments"],
  ["nodes", "Clients"], ["allocs", "Allocations"],
  ["evals", "Evaluations"], ["services", "Services"],
  ["storage", "Storage"], ["topology", "Topology"],
  ["servers", "Servers"],
];
$("#nav").innerHTML = NAV.map(([r, t]) =>
  `<a href="#/${r}" data-route="${r}">${t}</a>`).join("");
const searchInput = $("#search");
const searchBox = $("#searchresults");
let searchTimer = null;
let searchGen = 0;
searchInput.addEventListener("input", () => {
  clearTimeout(searchTimer);
  const prefix = searchInput.value.trim();
  const gen = ++searchGen;  // invalidates any in-flight response
  if (!prefix) { searchBox.innerHTML = ""; return; }
  searchTimer = setTimeout(async () => {
    let out;
    try {
      // namespace-scoped like the reference UI's search (matches carry
      // no namespace, so cross-namespace hits couldn't be routed);
      // list pages remain the cross-namespace view
      out = await api("/v1/search", {
        method: "POST", body: { Prefix: prefix, Context: "all" } });
    } catch (_) { return; }
    // a newer keystroke (or a clear) won while this was in flight
    if (gen !== searchGen) return;
    const routeOf = {
      jobs: (id) => `#/jobs/default/${id}`,
      nodes: (id) => `#/nodes/${id}`,
      allocs: (id) => `#/allocs/${id}`,
      deployments: () => `#/deployments`,
      evals: () => `#/evals`,
      volumes: () => `#/storage`,
      namespaces: null,  // list-only context, no page to land on
    };
    let html = "";
    for (const [ctx, ids] of Object.entries(out.Matches || {})) {
      if (!ids || !ids.length) continue;
      html += `<div class="ctx">${esc(ctx)}</div>`;
      for (const id of ids.slice(0, 8)) {
        const fn = routeOf[ctx];
        html += fn
          ? `<a href="${fn(encodeURIComponent(id))}">${esc(id)}</a>`
          : `<span class="dim" style="display:block;padding:5px 12px">`
            + `${esc(id)}</span>`;
      }
    }
    searchBox.innerHTML = html;
  }, 200);
});
function clearSearch() {
  searchGen++;
  searchBox.innerHTML = "";
}
searchBox.addEventListener("click", () => {
  clearSearch(); searchInput.value = "";
});
// dismiss on navigation, Escape, or clicking anywhere else
window.addEventListener("hashchange", clearSearch);
searchInput.addEventListener("keydown", (ev) => {
  if (ev.key === "Escape") { searchInput.value = ""; clearSearch(); }
});
document.addEventListener("click", (ev) => {
  if (ev.target !== searchInput && !searchBox.contains(ev.target))
    clearSearch();
});
const tokenInput = $("#token");
tokenInput.value = localStorage.getItem("nomad_token") || "";
tokenInput.addEventListener("change", () => {
  localStorage.setItem("nomad_token", tokenInput.value);
  render();
});

async function api(path, opts) {
  const headers = {};
  const tok = localStorage.getItem("nomad_token") || "";
  if (tok) headers["X-Nomad-Token"] = tok;
  let init = { headers };
  if (opts && opts.body !== undefined) {
    headers["Content-Type"] = "application/json";
    init = { method: opts.method || "POST", headers,
             body: JSON.stringify(opts.body) };
  } else if (opts && opts.method) {
    init = { method: opts.method, headers };
  }
  const resp = await fetch(path, init);
  const body = await resp.json().catch(() => ({}));
  if (!resp.ok) throw new Error(`${path}: ${body.error || resp.status}`);
  return body;
}

const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
  (c) => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;",
    "'":"&#39;"}[c]));
const short = (id) => esc(String(id || "").slice(0, 8));
function pill(status) {
  const cls = {
    running: "ok", ready: "ok", passing: "ok", complete: "ok",
    successful: "ok", healthy: "ok", true: "ok",
    pending: "warn", initializing: "warn", blocked: "warn",
    paused: "warn", critical: "bad", failed: "bad", dead: "bad",
    down: "bad", lost: "bad", false: "bad",
  }[String(status)] || "dim";
  return `<span class="pill ${cls}">${esc(status)}</span>`;
}
function table(headers, rows) {
  if (!rows.length) return `<p class="dim">none</p>`;
  return `<table><thead><tr>${headers.map((h) =>
    `<th>${h}</th>`).join("")}</tr></thead><tbody>${rows.map((r) =>
    `<tr>${r.map((c) => `<td>${c}</td>`).join("")}</tr>`).join("")
  }</tbody></table>`;
}
function pluginsTable(plugins) {
  return table(
    ["ID", "Controllers Healthy", "Nodes Healthy"],
    plugins.map((p) => [
      esc(p.id),
      `${p.controllers_healthy}/${p.controllers_expected}`,
      `${p.nodes_healthy}/${p.nodes_expected}`,
    ]));
}
function kv(pairs) {
  return `<dl class="kv">${pairs.map(([k, v]) =>
    `<dt>${esc(k)}</dt><dd>${v}</dd>`).join("")}</dl>`;
}

const views = {
  async jobs() {
    const jobs = await api("/v1/jobs?namespace=*");
    return `<h1>Jobs</h1>` + table(
      ["ID", "Namespace", "Type", "Priority", "Status"],
      jobs.map((j) => [
        `<a href="#/jobs/${esc(j.namespace)}/${esc(j.id)}">${esc(j.id)}</a>`,
        esc(j.namespace), esc(j.type), j.priority, pill(j.status),
      ]));
  },

  async job(ns, id) {
    const [job, allocs, evals] = await Promise.all([
      api(`/v1/job/${id}?namespace=${ns}`),
      api(`/v1/job/${id}/allocations?namespace=${ns}`),
      api(`/v1/job/${id}/evaluations?namespace=${ns}`),
    ]);
    setTimeout(() => {
      const b = $("#stopbtn");
      if (b) b.onclick = () => stopJob(job.namespace, job.id);
    }, 0);
    let html = `<h1>${esc(job.name || job.id)} ${pill(job.status)}
      <button class="danger" style="float:right" id="stopbtn">
        Stop</button></h1>`;
    html += kv([
      ["ID", esc(job.id)], ["Namespace", esc(job.namespace)],
      ["Type", esc(job.type)], ["Priority", job.priority],
      ["Datacenters", esc((job.datacenters || []).join(", "))],
      ["Version", job.version],
    ]);
    html += `<h2>Task Groups</h2>` + table(
      ["Name", "Count", "Tasks", "Volumes"],
      (job.task_groups || []).map((g) => [
        esc(g.name), g.count,
        esc((g.tasks || []).map((t) => `${t.name} (${t.driver})`)
          .join(", ")),
        esc(Object.keys(g.volumes || {}).join(", ") || "-"),
      ]));
    html += `<h2>Allocations</h2>` + table(
      ["ID", "Group", "Node", "Desired", "Status"],
      allocs.map((a) => [
        `<a href="#/allocs/${esc(a.id)}">${short(a.id)}</a>`,
        esc(a.task_group), short(a.node_id),
        esc(a.desired_status), pill(a.client_status),
      ]));
    html += `<h2>Evaluations</h2>` + table(
      ["ID", "Triggered By", "Status"],
      evals.map((e) => [short(e.id), esc(e.triggered_by),
        pill(e.status)]));
    return html;
  },

  async run() {
    const saved = sessionStorage.getItem("nomad_jobspec") ||
      `job "example" {\n  group "web" {\n    count = 1\n    task "app" {\n      driver = "mock"\n      config {}\n    }\n  }\n}\n`;
    setTimeout(() => {
      const ta = $("#jobsrc");
      if (!ta) return;
      ta.value = saved;
      ta.addEventListener("input", () =>
        sessionStorage.setItem("nomad_jobspec", ta.value));
      $("#btnplan").addEventListener("click", () => planJob());
      $("#btnrun").addEventListener("click", () => runJob());
    }, 0);
    return `<h1>Run Job</h1>
      <p class="dim">Paste an HCL jobspec; Plan dry-runs the scheduler
      against live state, Run submits it.</p>
      <textarea id="jobsrc" spellcheck="false"></textarea>
      <p style="margin:12px 0">
        <button id="btnrun">Run</button>
        <button id="btnplan" class="alt">Plan</button>
      </p>
      <div id="runout" class="dim">no output yet</div>`;
  },

  async deployments() {
    const deps = await api("/v1/deployments");
    setTimeout(() => {
      document.querySelectorAll("[data-dep-act]").forEach((b) => {
        b.onclick = async () => {
          const [act, id] = b.dataset.depAct.split("|");
          try {
            await api(`/v1/deployment/${act.replace("resume", "pause")
              }/${id}`, { method: "PUT",
              body: act === "pause" ? { Pause: true }
                : act === "resume" ? { Pause: false } : {} });
          } catch (e) {
            $("#err").textContent = `${act} failed: ${e.message || e}`;
            return;
          }
          render();
        };
      });
    }, 0);
    return `<h1>Deployments</h1>` + table(
      ["ID", "Job", "Status", "Description", "Groups", "Actions"],
      deps.map((d) => {
        const groups = Object.entries(d.task_groups || {}).map(
          ([g, st]) =>
            `${esc(g)}: ${st.healthy_allocs ?? 0}/${st.desired_total
            } healthy` + (st.desired_canaries
              ? ` (${(st.placed_canaries || []).length}/${
                st.desired_canaries} canaries${st.promoted
                ? ", promoted" : ""})` : "")
        ).join("<br>");
        const active = ["running", "paused", "pending"].includes(
          d.status);
        const pauseAct = d.status === "paused"
          ? `resume|${esc(d.id)}` : `pause|${esc(d.id)}`;
        const pauseLabel = d.status === "paused" ? "Resume" : "Pause";
        const acts = active
          ? `<button data-dep-act="promote|${esc(d.id)}">Promote`
            + `</button> <button class="alt" data-dep-act=`
            + `"${pauseAct}">${pauseLabel}</button> <button `
            + `class="danger" data-dep-act="fail|${esc(d.id)}">`
            + `Fail</button>`
          : `<span class="dim">—</span>`;
        return [
          short(d.id),
          `<a href="#/jobs/${esc(d.namespace)}/${esc(d.job_id)}">`
            + `${esc(d.job_id)}</a>`,
          pill(d.status), esc(d.status_description || "-"),
          groups, acts,
        ];
      }));
  },

  async nodes() {
    const nodes = await api("/v1/nodes");
    return `<h1>Clients</h1>` + table(
      ["ID", "Name", "DC", "Class", "Drivers", "Eligibility", "Status"],
      nodes.map((n) => [
        `<a href="#/nodes/${esc(n.id)}">${short(n.id)}</a>`,
        esc(n.name), esc(n.datacenter), esc(n.node_class || "-"),
        esc(Object.keys(n.drivers || {}).join(", ")),
        esc(n.scheduling_eligibility), pill(n.status),
      ]));
  },

  async node(id) {
    const [node, allocs] = await Promise.all([
      api(`/v1/node/${id}`), api(`/v1/node/${id}/allocations`),
    ]);
    const res = node.resources || {};
    setTimeout(() => {
      const d = $("#ndrain"), e = $("#nelig");
      if (d) d.onclick = async () => {
        const enable = !node.drain_strategy;
        try {
          await api(`/v1/node/${node.id}/drain`, { method: "PUT",
            body: { DrainSpec: enable ? { Deadline: 3600e9 } : null } });
        } catch (err) {
          $("#err").textContent = `drain failed: ${err.message || err}`;
          return;
        }
        render();
      };
      if (e) e.onclick = async () => {
        const elig = node.scheduling_eligibility === "eligible"
          ? "ineligible" : "eligible";
        try {
          await api(`/v1/node/${node.id}/eligibility`, { method: "PUT",
            body: { Eligibility: elig } });
        } catch (err) {
          $("#err").textContent =
            `eligibility failed: ${err.message || err}`;
          return;
        }
        render();
      };
    }, 0);
    let html = `<h1>${esc(node.name)} ${pill(node.status)}
      <span style="float:right">
        <button class="alt" id="nelig">${
          node.scheduling_eligibility === "eligible"
            ? "Mark ineligible" : "Mark eligible"}</button>
        <button class="danger" id="ndrain">${
          node.drain_strategy ? "Stop drain" : "Drain"}</button>
      </span></h1>`;
    html += kv([
      ["ID", esc(node.id)], ["Datacenter", esc(node.datacenter)],
      ["Class", esc(node.node_class || "-")],
      ["CPU", `${res.cpu ?? "?"} MHz`],
      ["Memory", `${res.memory_mb ?? "?"} MB`],
      ["Disk", `${res.disk_mb ?? "?"} MB`],
      ["Eligibility", esc(node.scheduling_eligibility)],
      ["CSI plugins",
        esc(Object.keys(node.csi_plugins || {}).join(", ") || "-")],
    ]);
    html += `<h2>Allocations</h2>` + table(
      ["ID", "Job", "Group", "Desired", "Status"],
      allocs.map((a) => [
        `<a href="#/allocs/${esc(a.id)}">${short(a.id)}</a>`,
        esc(a.job_id), esc(a.task_group), esc(a.desired_status),
        pill(a.client_status),
      ]));
    html += `<h2>Attributes</h2>` + table(
      ["Key", "Value"],
      Object.entries(node.attributes || {}).sort()
        .map(([k, v]) => [esc(k), esc(v)]));
    return html;
  },

  async allocs() {
    const allocs = await api("/v1/allocations?namespace=*");
    return `<h1>Allocations</h1>` + table(
      ["ID", "Job", "Group", "Node", "Desired", "Status"],
      allocs.map((a) => [
        `<a href="#/allocs/${esc(a.id)}">${short(a.id)}</a>`,
        esc(a.job_id), esc(a.task_group), short(a.node_id),
        esc(a.desired_status), pill(a.client_status),
      ]));
  },

  async alloc(id) {
    const a = await api(`/v1/allocation/${id}`);
    let html = `<h1>Allocation ${short(a.id)} `
      + `${pill(a.client_status)}</h1>`;
    html += kv([
      ["ID", esc(a.id)], ["Job", esc(a.job_id)],
      ["Task Group", esc(a.task_group)], ["Node", esc(a.node_id)],
      ["Desired", esc(a.desired_status)],
      ["Eval", esc(a.eval_id)],
    ]);
    const states = a.task_states || {};
    html += `<h2>Tasks</h2>` + table(
      ["Task", "State", "Failed", "Restarts", "Last Event"],
      Object.entries(states).map(([name, st]) => {
        const ev = (st.events || []).slice(-1)[0] || {};
        return [esc(name), pill(st.state), pill(!!st.failed),
          st.restarts || 0,
          esc(ev.type ? `${ev.type} ${ev.details || ""}` : "-")];
      }));
    if (a.client_status === "running") {
      const tasks = Object.keys(states);
      setTimeout(() => {
        const b = $("#xconnect");
        if (b) b.onclick = () => execConnect(a.id);
      }, 0);
      html += `<h2>Exec</h2>
        <p>
          <select id="xtask">${tasks.map((t) =>
            `<option value="${esc(t)}">${esc(t)}</option>`).join("")}
          </select>
          <input id="xcmd" value="/bin/sh" style="width:220px;
            background:var(--bg);color:var(--fg);
            border:1px solid var(--line);border-radius:4px;
            padding:5px 8px">
          <button id="xconnect">Connect</button>
        </p>
        <div id="term" class="dim">not connected</div>
        <input id="xin" placeholder="stdin — Enter sends a line"
          style="margin-top:8px">`;
    }
    return html;
  },

  async evals() {
    const evals = await api("/v1/evaluations");
    return `<h1>Evaluations</h1>` + table(
      ["ID", "Job", "Type", "Triggered By", "Priority", "Status"],
      evals.slice(0, 200).map((e) => [
        short(e.id), esc(e.job_id), esc(e.type), esc(e.triggered_by),
        e.priority, pill(e.status),
      ]));
  },

  async services() {
    const svcs = await api("/v1/services?namespace=*");
    return `<h1>Services</h1>` + table(
      ["Name", "Namespace", "Tags", "Instances"],
      svcs.map((s) => [
        esc(s.service_name), esc(s.namespace),
        esc((s.tags || []).join(", ")), s.instances,
      ]));
  },

  async storage() {
    const [vols, plugins, namespaces] = await Promise.all([
      api("/v1/volumes?namespace=*").catch(() => []),
      api("/v1/plugins"),
      api("/v1/namespaces"),
    ]);
    let html = `<h1>Storage</h1><h2>Volumes</h2>` + table(
      ["ID", "Namespace", "Type", "Plugin", "Access Mode", "Claims"],
      (vols || []).map((v) => [
        esc(v.id), esc(v.namespace), esc(v.type),
        esc(v.plugin_id || "-"), esc(v.access_mode),
        Object.keys(v.claims || {}).length,
      ]));
    html += `<h2>CSI Plugins</h2>` + pluginsTable(plugins);
    html += `<h2>Namespaces</h2>` + table(
      ["Name", "Description"],
      namespaces.map((n) => [esc(n.name), esc(n.description || "-")]));
    return html;
  },

  async topology() {
    const [nodes, allocs] = await Promise.all([
      api("/v1/nodes"), api("/v1/allocations?namespace=*"),
    ]);
    const byNode = {};
    for (const a of allocs) {
      if (a.client_status !== "running") continue;
      (byNode[a.node_id] = byNode[a.node_id] || []).push(a);
    }
    const rows = nodes.map((n) => {
      const na = byNode[n.id] || [];
      const res = n.resources || {};
      const used = na.reduce((s, a) => {
        const tasks = (a.resources || {}).tasks || {};
        return s + Object.values(tasks)
          .reduce((t, r) => t + (r.cpu || 0), 0);
      }, 0);
      const cap = res.cpu || 1;
      const pct = Math.min(100, Math.round(100 * used / cap));
      return [
        `<a href="#/nodes/${esc(n.id)}">${short(n.id)}</a>`,
        esc(n.datacenter), pill(n.status), na.length,
        `<span class="barbg"><span class="bar" style="width:${pct}%">` +
        `</span></span> <span class="dim">${pct}% cpu</span>`,
      ];
    });
    return `<h1>Topology</h1>` +
      table(["Node", "DC", "Status", "Running Allocs", "CPU"], rows);
  },

  async servers() {
    const [peers, leader] = await Promise.all([
      api("/v1/operator/raft/configuration"),
      api("/v1/status/leader").catch(() => "?"),
    ]);
    return `<h1>Servers</h1>` +
      `<p class="dim">leader: <code>${esc(leader)}</code></p>` +
      table(["ID", "Address", "Leader"],
        peers.map((p) => [
          esc(p.id), esc((p.address || []).join(":")),
          pill(!!p.leader),
        ]));
  },
};

async function parseJob() {
  const src = $("#jobsrc").value;
  const out = await api("/v1/jobs/parse", { body: { JobHCL: src } });
  return out.Job;
}
async function planJob() {
  const el = $("#runout");
  el.textContent = "planning…";
  try {
    const job = await parseJob();
    const plan = await api(
      `/v1/job/${encodeURIComponent(job.id)}/plan`,
      { method: "PUT", body: { Job: job, Diff: true } });
    const ann = plan.Annotations || plan.annotations || {};
    const tg = ann.DesiredTGUpdates || ann.desired_tg_updates || {};
    let lines = [`plan for ${job.id}:`];
    for (const [g, u] of Object.entries(tg)) {
      lines.push(
        `  group ${g}: +${u.Place ?? u.place ?? 0} place, ` +
        `${u.DestructiveUpdate ?? u.destructive ?? 0} destructive, ` +
        `${u.InPlaceUpdate ?? u.in_place_update ?? 0} in-place, ` +
        `${u.Stop ?? u.stop ?? 0} stop, ` +
        `${u.Ignore ?? u.ignore ?? 0} ignore`);
    }
    if (plan.FailedTGAllocs && Object.keys(plan.FailedTGAllocs).length)
      lines.push(`  FAILED groups: ` +
        Object.keys(plan.FailedTGAllocs).join(", "));
    el.textContent = lines.join("\n");
  } catch (e) { el.textContent = String(e.message || e); }
}
async function runJob() {
  const el = $("#runout");
  el.textContent = "submitting…";
  try {
    const job = await parseJob();
    const out = await api("/v1/jobs", { method: "PUT",
      body: { Job: job } });
    const evalId = typeof out === "string" ? out :
      (out.EvalID || out.eval_id || "");
    el.textContent = `submitted: eval ${evalId}`;
    location.hash = `#/jobs/${job.namespace || "default"}/${job.id}`;
  } catch (e) { el.textContent = String(e.message || e); }
}
async function stopJob(ns, id) {
  if (!confirm(`Stop job ${id}?`)) return;
  try {
    await api(
      `/v1/job/${encodeURIComponent(id)}?namespace=` +
      encodeURIComponent(ns), { method: "DELETE" });
  } catch (e) {
    $("#err").textContent = `stop failed: ${e.message || e}`;
    return;
  }
  render();
}

// -- browser exec terminal (WebSocket to the agent's exec bridge) ------
let execWs = null;
function execConnect(allocId) {
  const term = $("#term");
  const task = $("#xtask").value;
  const cmd = $("#xcmd").value || "/bin/sh";
  term.textContent = "";
  // a pending auto-refresh would re-render and detach this terminal
  clearTimeout(refreshTimer);
  if (execWs) { try { execWs.close(); } catch (_) {} }
  const tok = localStorage.getItem("nomad_token") || "";
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const params = new URLSearchParams();
  for (const part of cmd.split(" ").filter(Boolean))
    params.append("command", part);
  if (task) params.set("task", task);
  if (tok) params.set("token", tok);
  const ws = new WebSocket(
    `${proto}://${location.host}/v1/client/allocation/${allocId}` +
    `/exec?${params}`);
  execWs = ws;
  const append = (txt) => {
    term.textContent += txt;
    term.scrollTop = term.scrollHeight;
  };
  ws.onopen = () => append(`connected: ${cmd}\n`);
  ws.onmessage = (ev) => {
    try {
      const m = JSON.parse(ev.data);
      if (m.stdout) append(atob(m.stdout));
      if (m.error) append(`\n[error] ${m.error}\n`);
      if (m.exit) append("\n[session ended]\n");
    } catch (_) {}
  };
  ws.onclose = () => {
    append("\n[disconnected]\n");
    // session over: let the alloc page resume its auto-refresh cycle
    clearTimeout(refreshTimer);
    refreshTimer = setTimeout(render, 5000);
  };
  const input = $("#xin");
  input.onkeydown = (ev) => {
    if (ev.key !== "Enter") return;
    const line = input.value + "\n";
    input.value = "";
    append(line);
    if (ws.readyState === 1)
      ws.send(JSON.stringify({ stdin: btoa(line) }));
  };
  input.focus();
}

let refreshTimer = null;
let renderGen = 0;
async function render() {
  const gen = ++renderGen;
  const hash = location.hash.replace(/^#\//, "") || "jobs";
  const parts = hash.split("/").map(decodeURIComponent);
  document.querySelectorAll("#nav a").forEach((a) =>
    a.classList.toggle("active", a.dataset.route === parts[0]));
  let fn, args;
  if (parts[0] === "jobs" && parts.length === 3) {
    fn = views.job; args = [parts[1], parts[2]];
  } else if (parts[0] === "nodes" && parts.length === 2) {
    fn = views.node; args = [parts[1]];
  } else if (parts[0] === "allocs" && parts.length === 2) {
    fn = views.alloc; args = [parts[1]];
  } else {
    fn = views[parts[0]] || views.jobs; args = [];
  }
  try {
    const html = await fn(...args);
    if (gen !== renderGen) return;  // a newer navigation won
    $("#err").textContent = "";
    $("#view").innerHTML = html;
  } catch (e) {
    if (gen !== renderGen) return;
    $("#err").textContent = String(e.message || e);
  }
  clearTimeout(refreshTimer);
  // the editor and a CONNECTED exec terminal must not be wiped by
  // auto-refresh; an alloc page without a live session still refreshes
  const termLive = execWs && execWs.readyState <= 1 &&
    parts[0] === "allocs" && parts.length === 2;
  if (parts[0] !== "run" && !termLive)
    refreshTimer = setTimeout(render, 5000);
}
window.addEventListener("hashchange", render);
render();
</script>
</body>
</html>
"""
