from .linear import LinearPower, EHPower, NoWiggleEHPower
from .halofit import HalofitPower
from .zeldovich import ZeldovichPower

__all__ = ['LinearPower', 'EHPower', 'NoWiggleEHPower', 'HalofitPower',
           'ZeldovichPower']
