"""reference_reuse_share: the share of the perturbation path's frames whose
reference orbit ``ops/perturb.resolve_reference`` did not walk afresh:
``RENDER_STATS["reference"]`` "memo" (the view's own) or "reuse" (a cached
orbit whose c lies in the view), against "walk".  None where no frame took
that path."""


def read(rec):
    refs = [f["stats"].get("reference") for f in rec["frames"]]
    refs = [r for r in refs if r in ("memo", "reuse", "walk")]
    if not refs:
        return None
    return sum(r != "walk" for r in refs) / len(refs)
