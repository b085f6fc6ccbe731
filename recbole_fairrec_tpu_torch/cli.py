"""Console entry point (``run_recbole_torch``, installed by pyproject.toml).

Counterpart of ``recbole_fairrec_tpu/cli.py``: the flags ``--model/-m``,
``--dataset/-d`` and ``--config_files/-c``; extra ``--key=value`` arguments
are read by ``Config`` as overrides of the highest priority (``--use_gpu=False``
trains on the CPU).

    python -m recbole_fairrec_tpu_torch.cli -m PFCN_PMF -d ml-100k --epochs=2
"""

import argparse


def main(argv=None):
    from recbole_fairrec_tpu_torch import run_recbole

    parser = argparse.ArgumentParser(prog="run_recbole_torch")
    parser.add_argument("--model", "-m", type=str, default="FOCF", help="name of models")
    parser.add_argument("--dataset", "-d", type=str, default="ml-100k", help="name of datasets")
    parser.add_argument("--config_files", "-c", type=str, default=None, help="config files")
    args, _ = parser.parse_known_args(argv)
    config_file_list = args.config_files.strip().split(" ") if args.config_files else None
    return run_recbole(model=args.model, dataset=args.dataset, config_file_list=config_file_list)


if __name__ == "__main__":
    main()
