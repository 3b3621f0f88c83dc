"""Per iteration, the time outside ``collect`` and ``update``: the read-back
of every metric to a host float and the episode stats."""


def read(run):
    rows = run.spans
    if not rows:
        return None
    return 1e3 * sum(r["iteration"] - r["collect"] - r["update"] for r in rows) / len(rows)
