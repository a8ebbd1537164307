"""Operations and bytes computed from shapes: the kernels' bounds on the H100's
published peaks, and the models' FLOPs a forward, frozen here so that a later
change to the program cannot move the yardstick.

Each input byte is counted read once and each output byte written once; a
product of an M×K by a K×N matrix is 2·M·K·N operations. Only the products
(convolutions, dense layers, attention's two products) count toward a model's
FLOPs; normalisations and activations do not.
"""
