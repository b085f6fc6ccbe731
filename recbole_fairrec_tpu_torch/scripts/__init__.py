"""Command-line tools of the port, run as ``python -m
recbole_fairrec_tpu_torch.scripts.<name>``: ``run_recbole``, ``run_hyper``
and ``resume_run_recbole`` (counterparts of the repository's
``scripts/run_recbole.py``, ``run_hyper.py`` and ``resume_run_recbole.py``).
Extra ``--key=value`` arguments are config overrides (``--use_gpu=False``
runs on the CPU)."""
