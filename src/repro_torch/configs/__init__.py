from repro_torch.configs.msp_brain import CONFIG, SMOKE_CONFIG, BrainConfig

__all__ = ["BrainConfig", "CONFIG", "SMOKE_CONFIG"]
