from repro_torch.data.tokens import make_token_stream, token_batches
