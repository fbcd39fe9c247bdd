"""Host time of the service outside its device entry points per request, us."""
from nspubench import readers


def read(ctx):
    return readers.service_self_us(ctx)
