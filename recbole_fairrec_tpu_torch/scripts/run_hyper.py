"""Hyperparameter search from the command line: one ``objective_function``
trial (train + test) per point of the space in ``--params_file``.

    python -m recbole_fairrec_tpu_torch.scripts.run_hyper --config_files=fixed.yaml \\
        --params_file=space.hyper --algo=exhaustive
"""

import argparse

from recbole_fairrec_tpu_torch.quick_start import objective_function
from recbole_fairrec_tpu_torch.trainer.hyper_tuning import HyperTuning


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_files", type=str, default=None, help="fixed config files")
    parser.add_argument("--params_file", type=str, default=None, help="parameters file")
    parser.add_argument("--output_file", type=str, default="hyper_example.result",
                        help="output file")
    parser.add_argument("--algo", type=str, default="exhaustive",
                        help="exhaustive | random | anneal | bayes")
    parser.add_argument("--max_evals", type=int, default=100)
    args, _ = parser.parse_known_args(argv)

    config_file_list = args.config_files.strip().split(" ") if args.config_files else None
    hp = HyperTuning(
        objective_function,
        algo=args.algo,
        max_evals=args.max_evals,
        params_file=args.params_file,
        fixed_config_file_list=config_file_list,
    )
    hp.run()
    hp.export_result(output_file=args.output_file)
    print("best params: ", hp.best_params)
    print("best result: ")
    print(hp.params2result[hp.params2str(hp.best_params)])
    return hp


if __name__ == "__main__":
    main()
