"""Contact-graph analytics: the networkx replacement for the reference's
petgraph GraphMaps (visualisation/src/citizen_connections.rs).

The port's copy of ``epidemicsimulator_tpu/viz/graphs.py``; a world's
lanes may be numpy arrays or torch tensors on any device.  networkx is
imported inside each function.

* citizen co-occupancy graph (:37-64): citizens linked when they share a
  household, workplace or class, sampled for tractability at scale
* home-OA -> work-OA weighted commuting digraph (:66-93)
* household <-> workplace building graph (:95-123)
* connected-component count (:125-127) and graphviz dump (:129-143)
"""

from __future__ import annotations

import numpy as np

from ..world.geometry import _host


def citizen_connections(world, max_citizens: int | None = 50_000, seed: int = 0):
    """Graph over citizens; edges between members of the same mixing group."""
    import networkx as nx

    n = world.n_citizens
    rng = np.random.default_rng(seed)
    sel = (
        np.sort(rng.choice(n, max_citizens, replace=False))
        if max_citizens and n > max_citizens
        else np.arange(n)
    )
    g = nx.Graph()
    g.add_nodes_from(sel.tolist())
    hb = _host(world.home_building)[sel]
    wb = _host(world.work_building)[sel]
    rooms = _host(world.room)[sel]
    school = _host(world.is_school_work)[sel]

    def link_groups(ids, groups):
        order = np.argsort(groups, kind="stable")
        ids, groups = ids[order], groups[order]
        starts = np.flatnonzero(np.r_[True, groups[1:] != groups[:-1]])
        ends = np.r_[starts[1:], len(groups)]
        for s, e in zip(starts, ends):
            members = ids[s:e]
            for i in range(len(members) - 1):  # a path within a group is enough
                g.add_edge(int(members[i]), int(members[i + 1]))

    link_groups(sel, hb)
    # work group: the room for school citizens, the building otherwise
    wg = np.where(school, world.n_buildings + rooms, wb)
    link_groups(sel, wg)
    return g


def commuting_digraph(world):
    """Weighted home-OA -> work-OA digraph (citizen_connections.rs:66-93)."""
    import networkx as nx

    ho = _host(world.home_oa)
    wo = _host(world.work_oa)
    key = ho.astype(np.int64) * world.n_output_areas + wo
    uniq, counts = np.unique(key, return_counts=True)
    g = nx.DiGraph()
    for k, c in zip(uniq, counts):
        g.add_edge(int(k // world.n_output_areas), int(k % world.n_output_areas),
                   weight=int(c))
    return g


def building_graph(world, max_citizens: int | None = 100_000, seed: int = 0):
    """Household <-> workplace building graph (:95-123)."""
    import networkx as nx

    n = world.n_citizens
    rng = np.random.default_rng(seed)
    sel = (
        rng.choice(n, max_citizens, replace=False)
        if max_citizens and n > max_citizens
        else np.arange(n)
    )
    hb = _host(world.home_building)[sel]
    wb = _host(world.work_building)[sel]
    g = nx.Graph()
    for h, w in zip(hb.tolist(), wb.tolist()):
        if h != w:
            g.add_edge(h, w)
    return g


def connected_components_count(g) -> int:
    import networkx as nx

    return nx.number_connected_components(g.to_undirected() if g.is_directed() else g)


def dump_graphviz(g, path: str) -> str:
    """Plain-text DOT dump (citizen_connections.rs:129-143)."""
    with open(path, "w") as f:
        directed = g.is_directed()
        f.write("digraph G {\n" if directed else "graph G {\n")
        arrow = "->" if directed else "--"
        for u, v, data in g.edges(data=True):
            w = data.get("weight")
            attr = f' [weight={w}]' if w is not None else ""
            f.write(f"  {u} {arrow} {v}{attr};\n")
        f.write("}\n")
    return path
