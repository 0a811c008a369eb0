"""Cost of one ``epochs_mean_power_itc`` call: the call of
``epochs_power_itc``, so its count."""
from .epochs_power_itc import cost

__all__ = ["cost"]
