"""Evaluate a trained scheme into predictions/results.yaml, on the card unless
``--device`` names another device:

    python -m tgt_torch.cli.do_evaluations <config.yaml|model_dir> \
        ['key: value']... [--device cpu]
"""
from tgt_torch.cli.execute import main

if __name__ == "__main__":
    main("evaluate")
