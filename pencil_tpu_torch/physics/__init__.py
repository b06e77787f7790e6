from .density import Density
from .eos import EosIdealGas
from .forcing import Forcing
from .hydro import Hydro
from .magnetic import Magnetic
from .viscosity import Viscosity

__all__ = ["Density", "EosIdealGas", "Forcing", "Hydro", "Magnetic",
           "Viscosity"]
