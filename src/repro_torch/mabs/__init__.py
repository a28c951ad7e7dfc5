from repro_torch.mabs.sis import SISConfig, SISModel
from repro_torch.mabs.voter import VoterConfig, VoterModel

__all__ = ["SISModel", "SISConfig", "VoterModel", "VoterConfig"]
