"""Interest-aware CPQx (the paper's Sec. V) at the configuration's ``k``
over the run's interest set: the configuration's ``interests`` name the
pool it is drawn from and how many of its most frequent 2-label
sequences it holds (``bench.pools.prepare``); the program adds every
1-label sequence itself."""


def build(graph, cfg: dict, interests, device=None):
    from repro_torch.core import interest

    if not interests:
        raise ValueError(f"{cfg['name']}: iaCPQx needs an interest set")
    return interest.build_interest(graph, cfg["k"], list(interests),
                                   device=device)
