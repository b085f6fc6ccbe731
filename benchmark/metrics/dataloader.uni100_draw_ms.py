"""Host time a validation spends fetching the sampled loader's batches (the
100 negatives per validation item drawn on the host), in ms a validation:
the benchmark's span around ``NegSampleEvalDataLoader``'s fetch."""


def read(run):
    n = run.work.get("validations", 0)
    if not n:
        return None
    return 1e3 * run.rec.total("loader.fetch") / n
