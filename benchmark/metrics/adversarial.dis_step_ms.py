"""Host wall of the window's discriminator passes (the benchmark's span
around ``PFCNTrainer._run_epoch``) over their steps, in ms a step."""


def read(run):
    steps = run.work.get("steps.dis", 0)
    if not steps:
        return None
    return 1e3 * run.rec.total("adversarial.dis_pass") / steps
