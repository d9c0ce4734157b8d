from repro_torch.utils.device import resolve_device, torch_dtype  # noqa: F401
