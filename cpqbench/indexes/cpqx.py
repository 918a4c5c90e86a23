"""Full CPQx (the paper's Sec. IV) at the configuration's ``k``."""


def build(graph, cfg: dict, interests, device=None):
    from repro_torch.core import index

    return index.build(graph, cfg["k"], device=device)
