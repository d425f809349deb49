from .frame import (SCHEME_DEFAULT, SCHEME_SLEEP, SCHEME_TEMPERATURE,
                    make_renderer)

__all__ = ["make_renderer", "SCHEME_DEFAULT", "SCHEME_SLEEP",
           "SCHEME_TEMPERATURE"]
