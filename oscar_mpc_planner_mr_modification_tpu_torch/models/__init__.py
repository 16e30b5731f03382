from .dynamics import (  # noqa: F401
    DynamicsModel,
    SecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModelCurvatureAware,
    ContouringSecondOrderUnicycleModelWithSlack,
    BicycleModel2ndOrder,
    BicycleModel2ndOrderCurvatureAware,
    ModelView,
)
