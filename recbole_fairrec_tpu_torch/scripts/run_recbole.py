"""Train and test one model from the command line (``cli.main``).

    python -m recbole_fairrec_tpu_torch.scripts.run_recbole -m PFCN_PMF -d ml-100k --epochs=2
"""

from recbole_fairrec_tpu_torch.cli import main

if __name__ == "__main__":
    main()
