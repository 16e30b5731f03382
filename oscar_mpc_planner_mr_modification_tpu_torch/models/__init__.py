from .dynamics import (  # noqa: F401
    DynamicsModel,
    SecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModelWithSlack,
    ModelView,
)
