from repro_torch.data.tokens import make_token_stream, token_batches
from repro_torch.data.synthetic import (
    Dataset, make_blobs, make_classification, make_regression,
    train_test_split,
)
from repro_torch.data.partition import split_channels, split_features
