"""Prefix + fuzzy search across cluster objects.

Reference: nomad/search_endpoint.go — /v1/search resolves a prefix to ids
per context (jobs, evals, allocs, nodes, deployments, namespaces,
volumes) with a 20-item truncation per context; /v1/search/fuzzy matches
substrings and also reaches into job structure (group/task names).
"""

from __future__ import annotations

TRUNCATE_LIMIT = 20

ALL_CONTEXTS = (
    "jobs",
    "evals",
    "allocs",
    "nodes",
    "deployments",
    "namespaces",
    "volumes",
)


def _collect(state, namespace: str, contexts):
    """context -> [(id, extra)] — only the REQUESTED contexts are
    materialized, and namespace-scoped objects are filtered to the
    authorized namespace (the ACL gate checks read-job on it; returning
    other namespaces' eval/alloc/deployment ids would leak them —
    reference search_endpoint.go filters per context the same way).
    Nodes and namespace names are cluster-scoped infrastructure."""
    makers = {
        "jobs": lambda: [(j.id, None) for j in state.jobs(namespace)],
        "evals": lambda: [
            (e.id, None) for e in state.evals() if e.namespace == namespace
        ],
        "allocs": lambda: [
            (a.id, None) for a in state.allocs() if a.namespace == namespace
        ],
        "nodes": lambda: [(n.id, n.name) for n in state.nodes()],
        "deployments": lambda: [
            (d.id, None)
            for d in state.deployments()
            if d.namespace == namespace
        ],
        "namespaces": lambda: [(n.name, None) for n in state.namespaces()],
        "volumes": lambda: [(v.id, None) for v in state.volumes(namespace)],
    }
    return {ctx: makers[ctx]() for ctx in contexts if ctx in makers}


def prefix_search(state, prefix: str, context: str = "all",
                  namespace: str = "default") -> dict:
    contexts = ALL_CONTEXTS if context in ("", "all") else (context,)
    universe = _collect(state, namespace, contexts)
    matches: dict[str, list[str]] = {}
    truncations: dict[str, bool] = {}
    for ctx in contexts:
        ids = sorted(
            i for i, _ in universe.get(ctx, []) if i.startswith(prefix)
        )
        truncations[ctx] = len(ids) > TRUNCATE_LIMIT
        if ids:
            matches[ctx] = ids[:TRUNCATE_LIMIT]
    return {"Matches": matches, "Truncations": truncations}


def fuzzy_search(state, text: str, context: str = "all",
                 namespace: str = "default") -> dict:
    """Substring match; jobs also expose group/task scopes (reference
    fuzzyMatchesJob)."""
    text_l = text.lower()
    contexts = ALL_CONTEXTS if context in ("", "all") else (context,)
    universe = _collect(state, namespace, contexts)
    matches: dict[str, list[dict]] = {}
    truncations: dict[str, bool] = {}
    # namespace-scoped contexts carry the namespace in Scope so a hit is
    # resolvable (reference fuzzyMatchesJob's scope convention)
    ns_scoped = {"jobs", "evals", "allocs", "deployments", "volumes"}
    for ctx in contexts:
        hits: list[dict] = []
        scope = [namespace] if ctx in ns_scoped else []
        for ident, extra in universe.get(ctx, []):
            if text_l in ident.lower() or (
                extra and text_l in str(extra).lower()
            ):
                hits.append({"ID": ident, "Scope": list(scope)})
        if ctx == "jobs":
            for job in state.jobs(namespace):
                for tg in job.task_groups:
                    if text_l in tg.name.lower():
                        hits.append(
                            {"ID": tg.name, "Scope": [namespace, job.id]}
                        )
                    for task in tg.tasks:
                        if text_l in task.name.lower():
                            hits.append(
                                {
                                    "ID": task.name,
                                    "Scope": [namespace, job.id, tg.name],
                                }
                            )
        truncations[ctx] = len(hits) > TRUNCATE_LIMIT
        if hits:
            matches[ctx] = hits[:TRUNCATE_LIMIT]
    return {"Matches": matches, "Truncations": truncations}
