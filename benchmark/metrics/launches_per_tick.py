"""launches_per_tick (launches/tick): the host's kernel launches (the CUDA
launch calls, ``cudaLaunch*`` and ``cuLaunch*``) in the traced window
over its ticks: the work of the tick composer and of host dispatch. Moves
ticks_per_s."""


def read(tr):
    if tr.launches == 0 or tr.ticks == 0:
        return None
    return tr.launches / tr.ticks
