from .dynamics import (  # noqa: F401
    DynamicsModel,
    ContouringSecondOrderUnicycleModel,
    ModelView,
)
