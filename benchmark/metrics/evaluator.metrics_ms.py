"""Host time a validation spends in ``Evaluator.evaluate`` (the twelve
metrics over the collected rows), in ms a validation."""


def read(run):
    n = run.work.get("validations", 0)
    if not n:
        return None
    return 1e3 * run.rec.total("evaluator.evaluate") / n
