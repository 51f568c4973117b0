"""The port's host backends (python, lua, custom, custom-easy, dummy) and
its copy of the Lua interpreter against the JAX package's, on the CPU.

The scripts are those of ``tests/test_lua.py`` and
``tests/test_python_compat.py`` (reference-style ``nnstreamer_python``
scripts and native ones, passthrough and scaler filters, Lua chunks);
each runs through both packages on the same seeded inputs, and the
outputs must be EQUAL (host numpy work, no tolerance).
"""

import numpy as np
import pytest

from nnstreamer_tpu.filter.single import FilterSingle as JaxSingle
from nnstreamer_tpu.utils.minilua import LuaState as JaxLua
from nnstreamer_tpu_torch.filter.framework import (Accelerator, FilterError,
                                                   FilterProperties,
                                                   open_backend)
from nnstreamer_tpu_torch.filter.single import FilterSingle
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType
from nnstreamer_tpu_torch.utils.minilua import LuaState

PY_PASSTHROUGH_REF = (
    "import numpy as np\n"
    "import nnstreamer_python as nns\n"
    "D1, D2, D3 = 3, 10, 12\n"
    "class CustomFilter(object):\n"
    "    def __init__(self, *args):\n"
    "        self.input_dims = [nns.TensorShape([D1, D2, D3], np.uint8)]\n"
    "        self.output_dims = [nns.TensorShape([D1, D2, D3], np.uint8)]\n"
    "    def getInputDim(self):\n"
    "        return self.input_dims\n"
    "    def getOutputDim(self):\n"
    "        return self.output_dims\n"
    "    def invoke(self, input_array):\n"
    "        return input_array\n")

PY_SCALER_REF = (
    "import numpy as np\n"
    "import nnstreamer_python as nns\n"
    "class CustomFilter(object):\n"
    "    def __init__(self, *args):\n"
    "        self.new_x = 0\n"
    "        self.new_y = 0\n"
    "        if len(args) == 1:\n"
    "            x, y = args[0].split('x')\n"
    "            self.new_x, self.new_y = int(x), int(y)\n"
    "    def setInputDim(self, input_dims):\n"
    "        dims = input_dims[0].getDims()\n"
    "        if self.new_x > 0:\n"
    "            dims[1] = self.new_x\n"
    "        if self.new_y > 0:\n"
    "            dims[2] = self.new_y\n"
    "        return [nns.TensorShape(dims, input_dims[0].getType())]\n"
    "    def invoke(self, input_array):\n"
    "        x = input_array[0]\n"
    "        h, w = x.shape[0], x.shape[1]\n"
    "        ys = (np.arange(self.new_y) * h // self.new_y)\n"
    "        xs = (np.arange(self.new_x) * w // self.new_x)\n"
    "        return [np.ascontiguousarray(x[ys][:, xs])]\n")

PY_NATIVE = (
    "import numpy as np\n"
    "class CustomFilter:\n"
    "    def getInputDim(self):\n"
    "        return [((4, 2), 'float32')]\n"
    "    def getOutputDim(self):\n"
    "        return [((4, 2), 'float32'), ((1,), 'int32')]\n"
    "    def invoke(self, inputs):\n"
    "        x = np.asarray(inputs[0])\n"
    "        return [x * 2.0 + 1.0,\n"
    "                np.asarray([int(x.sum() * 10)], np.int32)]\n")

LUA_PASSTHROUGH = (
    "inputTensorsInfo = {num=1, dim={{3, 4, 2, 1}}, type={'uint8'}}\n"
    "outputTensorsInfo = {num=1, dim={{3, 4, 2, 1}}, type={'uint8'}}\n"
    "function nnstreamer_invoke()\n"
    "  input = input_tensor(1)\n"
    "  output = output_tensor(1)\n"
    "  for i=1,3*4*2 do output[i] = input[i] end\n"
    "end\n")

LUA_SCALER = (
    "inputTensorsInfo = {num=1, dim={{3, 8, 6, 1}}, type={'uint8'}}\n"
    "outputTensorsInfo = {num=1, dim={{3, 4, 3, 1}}, type={'uint8'}}\n"
    "function nnstreamer_invoke()\n"
    "  local input = input_tensor(1)\n"
    "  local output = output_tensor(1)\n"
    "  local inW, inH, outW, outH = 8, 6, 4, 3\n"
    "  for y=0,outH-1 do\n"
    "    local iy = math.floor(y * inH / outH)\n"
    "    for x=0,outW-1 do\n"
    "      local ix = math.floor(x * inW / outW)\n"
    "      for c=1,3 do\n"
    "        output[(y*outW + x)*3 + c] = input[(iy*inW + ix)*3 + c]\n"
    "      end\n"
    "    end\n"
    "  end\n"
    "end\n")

LUA_MATH = (
    "inputTensorsInfo = {num=2, dim={{4}, {4}}, type={'float32', 'float32'}}\n"
    "outputTensorsInfo = {num=1, dim={{4}}, type={'float32'}}\n"
    "function nnstreamer_invoke()\n"
    "  local a, b, out = input_tensor(1), input_tensor(2), output_tensor(1)\n"
    "  for i=1,4 do\n"
    "    if a[i] > b[i] then out[i] = a[i] * 2 else out[i] = b[i] ^ 2 end\n"
    "  end\n"
    "end\n")

#: interpreter chunks of tests/test_lua.py: (source, globals to compare)
LUA_CHUNKS = [
    ("""t = { num = 2, dim = {{3, 4}, {5}}, s = "hi" }
        x = t.dim[1][2] + t["num"] * 10
        y = math.floor(7 / 2) + 2 ^ 3
        z = "a" .. 1 .. true""", ("x", "y", "z")),
    ("""total = 0
        for i = 1, 10, 2 do total = total + i end
        n = 0
        while n < 4 do n = n + 1 if n == 3 then break end end
        if total > 20 then kind = "big" elseif total > 10 then
            kind = "mid" else kind = "small" end
        function add(a, b) return a + b end
        s = add(total, n)""", ("total", "n", "kind", "s")),
    ("""local a = {10, 20, 30}
        n = #a
        s = #"hello"
        f = string.format("%d-%s-%.2f", 7, "x", 1.5)
        r = string.rep("ab", 3) .. string.upper("q")""", ("n", "s", "f", "r")),
    ("""t = {}
        table.insert(t, 5) table.insert(t, 1, 4) table.insert(t, 6)
        c = table.concat(t, ",")
        k = 0
        for i, v in ipairs(t) do k = k + i * v end
        g = string.gsub("hello world", "o", "0")""", ("c", "k", "g")),
    ("""Point = {}
        Point.__index = Point
        function Point.new(x, y)
          local p = setmetatable({}, Point) p.x = x p.y = y return p
        end
        function Point:len2() return self.x * self.x + self.y * self.y end
        d = Point.new(3, 4):len2()""", ("d",)),
]


def _info(dims, dtype):
    return TensorsInfo([TensorInfo(TensorType.from_string(dtype), dims)])


def _jax_info(dims, dtype):
    from nnstreamer_tpu.tensor.info import TensorInfo as JI
    from nnstreamer_tpu.tensor.info import TensorsInfo as JIs
    from nnstreamer_tpu.tensor.types import TensorType as JT

    return JIs([JI(JT.from_string(dtype), dims)])


def _both(framework, model, xs, custom=None, in_dims=None):
    kw, jkw = {}, {}
    if in_dims is not None:
        kw["input_info"] = _info(*in_dims)
        jkw["input_info"] = _jax_info(*in_dims)
    with JaxSingle(framework=framework, model=model, custom=custom,
                   **jkw) as j:
        jo = [np.asarray(o) for o in j.invoke(xs)]
        jinfo = (str(j.input_info), str(j.output_info))
    with FilterSingle(framework=framework, model=model, custom=custom,
                      **kw) as p:
        po = p.invoke(xs)
        pinfo = (str(p.input_info), str(p.output_info))
    assert jinfo == pinfo
    assert len(jo) == len(po)
    for a, b in zip(jo, po):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return po


class TestPython:
    def test_reference_passthrough(self, tmp_path):
        path = tmp_path / "passthrough.py"
        path.write_text(PY_PASSTHROUGH_REF)
        x = np.random.default_rng(0).integers(0, 256, (12, 10, 3),
                                              dtype=np.uint8)
        out = _both("python", str(path), [x])
        np.testing.assert_array_equal(out[0], x)

    def test_reference_scaler_negotiates(self, tmp_path):
        path = tmp_path / "scaler.py"
        path.write_text(PY_SCALER_REF)
        x = np.random.default_rng(1).integers(0, 256, (8, 16, 3),
                                              dtype=np.uint8)
        out = _both("python", str(path), [x], custom="8x4",
                    in_dims=((3, 16, 8), "uint8"))
        assert out[0].shape == (4, 8, 3)

    def test_native_two_outputs(self, tmp_path):
        path = tmp_path / "native.py"
        path.write_text(PY_NATIVE)
        x = np.random.default_rng(2).random((2, 4), np.float32)
        _both("python", str(path), [x])

    def test_missing_script_is_filter_error(self, tmp_path):
        with pytest.raises(FilterError):
            FilterSingle(framework="python",
                         model=str(tmp_path / "none.py")).start()


class TestLua:
    @pytest.mark.parametrize("chunk", range(len(LUA_CHUNKS)))
    def test_interpreter_chunks_agree(self, chunk):
        source, names = LUA_CHUNKS[chunk]
        a, b = JaxLua(source), LuaState(source)
        for name in names:
            assert a.get(name) == b.get(name), name

    def test_passthrough(self, tmp_path):
        path = tmp_path / "passthrough.lua"
        path.write_text(LUA_PASSTHROUGH)
        x = np.random.default_rng(3).integers(0, 256, (1, 2, 4, 3),
                                              dtype=np.uint8)
        _both("lua", str(path), [x])

    def test_scaler(self, tmp_path):
        path = tmp_path / "scaler.lua"
        path.write_text(LUA_SCALER)
        x = np.random.default_rng(4).integers(0, 256, (1, 6, 8, 3),
                                              dtype=np.uint8)
        _both("lua", str(path), [x])

    def test_inline_script_two_inputs(self):
        rng = np.random.default_rng(5)
        xs = [rng.random(4).astype(np.float32),
              rng.random(4).astype(np.float32)]
        _both("lua", LUA_MATH, xs)

    def test_runtime_fault_is_filter_error(self, tmp_path):
        path = tmp_path / "bad.lua"
        path.write_text(LUA_PASSTHROUGH.replace("input[i]", "input[i + 99]"))
        with FilterSingle(framework="lua", model=str(path)) as p:
            with pytest.raises(FilterError, match="invoke error"):
                p.invoke([np.zeros((1, 2, 4, 3), np.uint8)])

    def test_cuda_tensor_inputs_reach_the_host(self):
        """A device payload is copied to the host before the script reads
        it: the port's host backends take CPU tensors as numpy does."""
        import torch

        rng = np.random.default_rng(6)
        xs = [rng.random(4).astype(np.float32) for _ in range(2)]
        with FilterSingle(framework="lua", model=LUA_MATH) as p:
            a = p.invoke(xs)[0]
            b = p.invoke([torch.as_tensor(x) for x in xs])[0]
        np.testing.assert_array_equal(a, b)


class TestCustom:
    def test_custom_easy_both_packages(self):
        from nnstreamer_tpu.filter.backends.custom import (
            register_custom_easy as jreg, unregister_custom_easy as junreg)
        from nnstreamer_tpu_torch.filter.backends.custom import (
            register_custom_easy, unregister_custom_easy)

        fn = lambda ins: [np.asarray(ins[0]) * 3 - 1]  # noqa: E731
        register_custom_easy("easy_both", fn, _info((4, 2), "float32"),
                             _info((4, 2), "float32"))
        jreg("easy_both", fn, _jax_info((4, 2), "float32"),
             _jax_info((4, 2), "float32"))
        try:
            x = np.random.default_rng(7).random((2, 4), np.float32)
            _both("custom-easy", "easy_both", [x])
            with pytest.raises(ValueError):
                register_custom_easy("easy_both", fn, _info((1,), "uint8"),
                                     _info((1,), "uint8"))
        finally:
            unregister_custom_easy("easy_both")
            junreg("easy_both")

    def test_custom_object_and_callable(self):
        class Doubler:
            def get_input_info(self):
                return _info((3,), "int32")

            def get_output_info(self):
                return _info((3,), "int32")

            def invoke(self, inputs):
                return [inputs[0] * 2]

        x = np.arange(3, dtype=np.int32)
        with FilterSingle(framework="custom", model=Doubler()) as p:
            np.testing.assert_array_equal(p.invoke([x])[0], x * 2)
        with FilterSingle(framework="custom", model=lambda ins: ins[0] + 1,
                          input_info=_info((3,), "int32"),
                          output_info=_info((3,), "int32")) as p:
            np.testing.assert_array_equal(p.invoke([x])[0], x + 1)
        with pytest.raises(FilterError, match="requires input/output"):
            FilterSingle(framework="custom", model=lambda ins: ins).start()

    def test_dummy_zeros_and_count(self):
        fw = open_backend(FilterProperties(
            framework="dummy", input_info=_info((4,), "float32"),
            output_info=_info((2, 2), "uint8"),
            accelerators=[Accelerator.GPU]))
        out = fw.invoke([np.ones(4, np.float32)])
        assert out[0].shape == (2, 2) and out[0].dtype == np.uint8
        assert not out[0].any() and fw.invoke_count == 1
