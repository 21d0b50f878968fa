from .linear import LinearPower, EHPower, NoWiggleEHPower

__all__ = ['LinearPower', 'EHPower', 'NoWiggleEHPower']
