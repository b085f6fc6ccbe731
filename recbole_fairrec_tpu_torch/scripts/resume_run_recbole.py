"""Evaluate a checkpoint on its test split, or continue its training first
(``--resume``). The checkpoint may come from this package or from the JAX
package.

    python -m recbole_fairrec_tpu_torch.scripts.resume_run_recbole -f saved/model.pth [--resume]
"""

import argparse

from recbole_fairrec_tpu_torch import load_data_and_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_file", "-f", type=str, required=True, help="saved checkpoint")
    parser.add_argument("--resume", action="store_true",
                        help="continue training instead of eval-only")
    args, _ = parser.parse_known_args(argv)

    config, model, trainer, dataset, train_data, valid_data, test_data = load_data_and_model(
        args.model_file
    )
    if args.resume:
        trainer.resume_checkpoint(args.model_file)
        trainer.fit(train_data, valid_data, saved=True, show_progress=config["show_progress"])
    result = trainer.evaluate(test_data, load_best_model=True, model_file=args.model_file)
    print("test result:", dict(result) if result else result)
    return result


if __name__ == "__main__":
    main()
