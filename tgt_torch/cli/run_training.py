"""Train a scheme (resuming from the model dir's checkpoint), on the card unless
``--device`` names another device:

    python -m tgt_torch.cli.run_training <config.yaml|model_dir> \
        ['key: value']... [--device cpu]
"""
from tgt_torch.cli.execute import main

if __name__ == "__main__":
    main("train")
