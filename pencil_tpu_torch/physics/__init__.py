from .density import Density
from .entropy import Entropy
from .eos import EosIdealGas
from .forcing import Forcing
from .gravity import Gravity
from .hydro import Hydro
from .magnetic import Magnetic
from .shear import Shear
from .shock import Shock
from .viscosity import Viscosity

__all__ = ["Density", "Entropy", "EosIdealGas", "Forcing", "Gravity",
           "Hydro", "Magnetic", "Shear", "Shock", "Viscosity"]
