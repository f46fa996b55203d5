from repro_torch.data import sky
