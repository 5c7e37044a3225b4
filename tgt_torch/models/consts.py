"""Feature-space constants (reference: lib/models/pcqm/consts.py:1-7)."""

NODE_FEATURES_OFFSET = 128
NUM_NODE_FEATURES = 9
EDGE_FEATURES_OFFSET = 8
NUM_EDGE_FEATURES = 3

HL_MEAN = 5.6894608
HL_STD = 1.1621397
