from repro_torch.mabs.axelrod import AxelrodConfig, AxelrodModel
from repro_torch.mabs.sir import SIRConfig, SIRModel
from repro_torch.mabs.sis import SISConfig, SISModel
from repro_torch.mabs.voter import VoterConfig, VoterModel

__all__ = ["AxelrodModel", "AxelrodConfig", "SIRModel", "SIRConfig",
           "SISModel", "SISConfig", "VoterModel", "VoterConfig"]
