"""Host wall of the window's filter passes (the benchmark's span around
``PFCNTrainer._run_epoch``) over their steps, in ms a step."""


def read(run):
    steps = run.work.get("steps.filter", 0)
    if not steps:
        return None
    return 1e3 * run.rec.total("adversarial.filter_pass") / steps
