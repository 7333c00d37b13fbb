"""API and router: the share of the traced window's routing decisions
(``QueryRouter.decisions``) that went to the device or the mesh."""


def read(run):
    dev = run.delta("decisions", "device") + run.delta("decisions", "mesh")
    total = dev + run.delta("decisions", "host")
    return 100.0 * dev / total if total else None
