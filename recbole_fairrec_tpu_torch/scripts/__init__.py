"""Command-line tools of the port, run as ``python -m
recbole_fairrec_tpu_torch.scripts.<name>``: ``run_recbole``, ``run_hyper``,
``resume_run_recbole`` and ``parity_runs`` (counterparts of the repository's
``scripts/run_recbole.py``, ``run_hyper.py``, ``resume_run_recbole.py`` and
``parity_runs.py``).
Extra ``--key=value`` arguments of the first three are config overrides (``--use_gpu=False``
runs on the CPU)."""
