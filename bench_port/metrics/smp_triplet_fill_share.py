"""The real triplets over the triplet rows of the batches handed to the
device on rank 0 over the traced log period (the counters
``smp_triplets`` and ``smp_triplet_rows``: `graphs/batch.py::to_tensors`
where a batch carries ``tri_mask``), in %: the share of the triplet
bucket that `cli/train.py::make_loaders` sizes that holds real work.
Nothing where the program keeps no such counters, or where its
``loop.step`` calls are not the traced steps."""


def read(ctx):
    p = ctx["ranks"][0]["profile"]
    if p is None:
        return None
    try:
        from infomax3d_tpu_torch.utils.spans import tally
    except ImportError:
        return None
    t = tally()
    steps = t["spans"].get("loop.step", {}).get("calls")
    rows = t["counters"].get("smp_triplet_rows")
    if steps != p["steps"] or not rows or \
            "smp_triplets" not in t["counters"]:
        return None
    return t["counters"]["smp_triplets"] / rows * 100.0
