"""The paper's own anomaly-detection autoencoder (Table II):
32 -> 16 -> 8 -> 16 -> 32, ~1 352 parameters, D=32 features."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AEConfig:
    name: str = "paper-ae"
    feature_dim: int = 32
    hidden: tuple = (16, 8, 16)
    local_epochs: int = 5
    lr: float = 0.01
    rho_s: float = 0.05
    quant_bits: int = 8


CONFIG = AEConfig()
REDUCED = AEConfig(name="paper-ae-reduced", feature_dim=8, hidden=(4, 2, 4))
