"""Write a trained scheme's predictions, on the card unless
``--device`` names another device:

    python -m tgt_torch.cli.make_predictions <config.yaml|model_dir> \
        ['key: value']... [--device cpu]
"""
from tgt_torch.cli.execute import main

if __name__ == "__main__":
    main("predict")
