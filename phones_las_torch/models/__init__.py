"""Model layer: pyramidal BiLSTM listener, attention speller, LAS assembly.
The reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "ListenerConfig": "listener",
    "ListenerParams": "listener",
    "init_listener": "listener",
    "listen": "listener",
    "SpellerConfig": "speller",
    "SpellerParams": "speller",
    "init_speller": "speller",
    "speller_step": "speller",
    "init_speller_carry": "speller",
    "teacher_forced_decode": "speller",
    "LASConfig": "las",
    "LASParams": "las",
    "init_las": "las",
    "encode": "las",
    "compute_loss": "las",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
