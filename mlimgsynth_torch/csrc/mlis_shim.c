/* libmlimgsynth C ABI shim.
 *
 * Implements the stable mlis_* interface (include/mlimgsynth.h) over the
 * TPU-native Python core by embedding CPython and driving
 * mlimgsynth_torch.capi.  Mirrors the reference library's external behavior
 * (reference: src/mlimgsynth.c public entry points) so existing C clients
 * and the ctypes binding run unchanged.
 *
 * Build: make -C native   (produces lib/libmlimgsynth.so)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "../include/mlimgsynth.h"

struct MLIS_Ctx {
	PyObject *capi;        /* the mlimgsynth_torch.capi module */
	char errstr[1024];
	char infotext[8192];
	MLIS_Image imgex;
	MLIS_Tensor tensors[16];
	int32_t *tokens;
	MLIS_BackendInfo backend_info;
	MLIS_BackendDevInfo backend_devs[16];
	char backend_strs[4096];
};

static PyObject *g_capi = NULL;

static int mlis_global_init(void)
{
	if (g_capi) return 1;
	if (!Py_IsInitialized()) {
		PyConfig config;
		PyConfig_InitPythonConfig(&config);
		Py_InitializeFromConfig(&config);
		PyConfig_Clear(&config);
	}
	/* allow running from a source checkout: add the repo root (directory
	 * holding this library's python package) to sys.path */
	const char *extra = getenv("MLIS_PY_PATH");
	if (extra) {
		PyObject *sys_path = PySys_GetObject("path");
		PyObject *p = PyUnicode_FromString(extra);
		if (sys_path && p) PyList_Insert(sys_path, 0, p);
		Py_XDECREF(p);
	}
	g_capi = PyImport_ImportModule("mlimgsynth_torch.capi");
	if (!g_capi) {
		PyErr_Print();
		return -1;
	}
	return 1;
}

static PyObject* shim_call(MLIS_Ctx *S, const char *method,
	const char *fmt, ...)
{
	PyObject *sess = NULL, *meth = NULL, *args = NULL, *res = NULL;
	va_list ap;

	PyObject *get = PyObject_GetAttrString(S->capi, "get");
	if (!get) goto fail;
	sess = PyObject_CallFunction(get, "K", (unsigned long long)(uintptr_t)S);
	Py_DECREF(get);
	if (!sess || sess == Py_None) goto fail;

	va_start(ap, fmt);
	args = fmt && fmt[0] ? Py_VaBuildValue(fmt, ap) : PyTuple_New(0);
	va_end(ap);
	if (!args) goto fail;
	if (!PyTuple_Check(args)) {
		PyObject *t = PyTuple_Pack(1, args);
		Py_DECREF(args);
		args = t;
		if (!args) goto fail;
	}

	meth = PyObject_GetAttrString(sess, method);
	if (!meth) goto fail;
	res = PyObject_CallObject(meth, args);
	if (!res) goto fail;

	Py_DECREF(meth);
	Py_DECREF(args);
	Py_DECREF(sess);
	return res;

fail:
	if (PyErr_Occurred()) {
		PyObject *ptype, *pvalue, *ptb;
		PyErr_Fetch(&ptype, &pvalue, &ptb);
		PyObject *s = pvalue ? PyObject_Str(pvalue) : NULL;
		if (s) {
			snprintf(S->errstr, sizeof(S->errstr), "%s",
				PyUnicode_AsUTF8(s));
			Py_DECREF(s);
		}
		Py_XDECREF(ptype); Py_XDECREF(pvalue); Py_XDECREF(ptb);
	}
	Py_XDECREF(meth);
	Py_XDECREF(args);
	Py_XDECREF(sess);
	return NULL;
}

static int shim_call_i(MLIS_Ctx *S, const char *method, const char *fmt, ...)
{
	PyObject *sess = NULL, *meth = NULL, *args = NULL, *res = NULL;
	va_list ap;
	int r = MLIS_E_UNKNOWN;

	PyObject *get = PyObject_GetAttrString(S->capi, "get");
	if (!get) return MLIS_E_UNKNOWN;
	sess = PyObject_CallFunction(get, "K", (unsigned long long)(uintptr_t)S);
	Py_DECREF(get);
	if (!sess || sess == Py_None) { Py_XDECREF(sess); return MLIS_E_UNKNOWN; }

	va_start(ap, fmt);
	args = fmt && fmt[0] ? Py_VaBuildValue(fmt, ap) : PyTuple_New(0);
	va_end(ap);
	if (args && !PyTuple_Check(args)) {
		PyObject *t = PyTuple_Pack(1, args);
		Py_DECREF(args);
		args = t;
	}
	if (args) {
		meth = PyObject_GetAttrString(sess, method);
		if (meth) {
			res = PyObject_CallObject(meth, args);
			if (res) r = (int)PyLong_AsLong(res);
		}
	}
	if (!res && PyErr_Occurred()) {
		PyErr_Print();
		PyErr_Clear();
	}
	Py_XDECREF(res);
	Py_XDECREF(meth);
	Py_XDECREF(args);
	Py_XDECREF(sess);
	return r;
}

/* ---- lifecycle ---------------------------------------------------------- */

MLIS_Ctx* mlis_ctx_create_i(int version)
{
	if (!(0x000400 <= version && version < 0x000600)) {
		fprintf(stderr, "mlis incompatible version %06x\n", version);
		return NULL;
	}
	if (mlis_global_init() < 0) return NULL;

	MLIS_Ctx *S = calloc(1, sizeof(MLIS_Ctx));
	S->capi = g_capi;
	PyObject *r = PyObject_CallMethod(g_capi, "ctx_create", "K",
		(unsigned long long)(uintptr_t)S);
	if (!r) {
		PyErr_Print();
		free(S);
		return NULL;
	}
	Py_DECREF(r);
	return S;
}

void mlis_ctx_destroy(MLIS_Ctx **pS)
{
	if (!pS || !*pS) return;
	MLIS_Ctx *S = *pS;
	PyObject *r = PyObject_CallMethod(g_capi, "ctx_destroy", "K",
		(unsigned long long)(uintptr_t)S);
	Py_XDECREF(r);
	free(S->tokens);
	free(S);
	*pS = NULL;
}

const char* mlis_errstr_get(const MLIS_Ctx *S)
{
	MLIS_Ctx *m = (MLIS_Ctx*)S;
	PyObject *res = shim_call(m, "errstr_get", "");
	if (res) {
		snprintf(m->errstr, sizeof(m->errstr), "%s",
			PyUnicode_AsUTF8(res));
		Py_DECREF(res);
	}
	return S->errstr;
}

/* ---- options ------------------------------------------------------------ */

static const char* opt_name(MLIS_Option id);

int mlis_option_set_str(MLIS_Ctx *S, const char *name, const char *value)
{
	return shim_call_i(S, "option_set_str", "(ss)", name,
		value ? value : "");
}

/* Reference parity: option_get supports the string-valued options
 * (mlimgsynth_options_get.c.h). The out-pointer receives a ctx-owned
 * string valid until the next call. */
int mlis_option_get(MLIS_Ctx *S, MLIS_Option id, ...)
{
	const char *name = opt_name(id);
	if (!name) return MLIS_E_UNK_OPT;
	PyObject *res = shim_call(S, "option_get_str", "(s)", name);
	if (!res) return MLIS_E_UNKNOWN;
	snprintf(S->errstr + 512, sizeof(S->errstr) - 512, "%s",
		PyUnicode_AsUTF8(res));
	Py_DECREF(res);
	va_list ap;
	va_start(ap, id);
	const char **out = va_arg(ap, const char**);
	va_end(ap);
	if (out) *out = S->errstr + 512;
	return 1;
}

static const char* opt_name(MLIS_Option id)
{
	if (id < 0 || id > MLIS_OPT__LAST) return NULL;
	return mlis_option_str(id);
}

int mlis_option_set(MLIS_Ctx *S, MLIS_Option id, ...)
{
	char buf[512];
	va_list ap;
	va_start(ap, id);
	int r = MLIS_E_UNK_OPT;
	const char *name = opt_name(id);
	if (!name) goto end;

	switch (id) {
	case MLIS_OPT_BACKEND: {
		const char *a = va_arg(ap, const char*);
		const char *b = va_arg(ap, const char*);
		snprintf(buf, sizeof(buf), "%s,%s", a ? a : "", b ? b : "");
		r = mlis_option_set_str(S, name, buf);
	} break;
	case MLIS_OPT_MODEL: case MLIS_OPT_TAE: case MLIS_OPT_LORA_DIR:
	case MLIS_OPT_PROMPT: case MLIS_OPT_NPROMPT: case MLIS_OPT_AUX_DIR:
	case MLIS_OPT_CONTROL_NET: case MLIS_OPT_EMBED_DIR:
	case MLIS_OPT_REFINER: case MLIS_OPT_T5: case MLIS_OPT_T5_TOKENIZER:
	case MLIS_OPT_CLIP: case MLIS_OPT_VAE:
	case MLIS_OPT_SLG_LAYERS: case MLIS_OPT_FREEU:
		r = mlis_option_set_str(S, name, va_arg(ap, const char*));
		break;
	case MLIS_OPT_LORA: {
		const char *p = va_arg(ap, const char*);
		double m = va_arg(ap, double);
		snprintf(buf, sizeof(buf), "\"%s\",%g", p, m);
		r = mlis_option_set_str(S, name, buf);
	} break;
	case MLIS_OPT_LORA_CLEAR:
		r = mlis_option_set_str(S, name, "");
		break;
	case MLIS_OPT_IMAGE_DIM: {
		int w = va_arg(ap, int), h = va_arg(ap, int);
		snprintf(buf, sizeof(buf), "%d,%d", w, h);
		r = mlis_option_set_str(S, name, buf);
	} break;
	case MLIS_OPT_BATCH_SIZE: case MLIS_OPT_CLIP_SKIP: case MLIS_OPT_STEPS:
	case MLIS_OPT_NO_DECODE: case MLIS_OPT_TENSOR_USE_FLAGS:
	case MLIS_OPT_VAE_TILE: case MLIS_OPT_UNET_SPLIT: case MLIS_OPT_THREADS:
	case MLIS_OPT_DUMP_FLAGS: case MLIS_OPT_LOG_LEVEL:
	case MLIS_OPT_NO_PROMPT_PARSE: case MLIS_OPT_WEIGHT_TYPE:
	case MLIS_OPT_HIRES_STEPS: case MLIS_OPT_T5_TOKENS:
	case MLIS_OPT_DEEPCACHE:
		snprintf(buf, sizeof(buf), "%d", va_arg(ap, int));
		r = mlis_option_set_str(S, name, buf);
		break;
	case MLIS_OPT_CFG_SCALE: case MLIS_OPT_F_T_INI: case MLIS_OPT_F_T_END:
	case MLIS_OPT_S_NOISE: case MLIS_OPT_S_ANCESTRAL:
	case MLIS_OPT_CONTROL_STRENGTH: case MLIS_OPT_HIRES_FIX:
	case MLIS_OPT_HIRES_DENOISE: case MLIS_OPT_REFINER_SWITCH:
	case MLIS_OPT_CFG_RESCALE: case MLIS_OPT_SLG_SCALE:
	case MLIS_OPT_SLG_START: case MLIS_OPT_SLG_END:
	case MLIS_OPT_PAG_SCALE: case MLIS_OPT_PAG_START:
	case MLIS_OPT_PAG_END: case MLIS_OPT_SUBSEED_STRENGTH:
		snprintf(buf, sizeof(buf), "%.9g", va_arg(ap, double));
		r = mlis_option_set_str(S, name, buf);
		break;
	case MLIS_OPT_SEED: case MLIS_OPT_SUBSEED:
		snprintf(buf, sizeof(buf), "%llu",
			(unsigned long long)va_arg(ap, uint64_t));
		r = mlis_option_set_str(S, name, buf);
		break;
	case MLIS_OPT_METHOD:
		r = mlis_option_set_str(S, name,
			mlis_method_str((MLIS_Method)va_arg(ap, int)));
		break;
	case MLIS_OPT_SCHEDULER:
		r = mlis_option_set_str(S, name,
			mlis_sched_str((MLIS_Scheduler)va_arg(ap, int)));
		break;
	case MLIS_OPT_MODEL_TYPE:
		r = mlis_option_set_str(S, name,
			mlis_model_type_str((MLIS_ModelType)va_arg(ap, int)));
		break;
	case MLIS_OPT_IMAGE: {
		const MLIS_Image *img = va_arg(ap, const MLIS_Image*);
		r = shim_call_i(S, "set_image", "(KIII)",
			(unsigned long long)(uintptr_t)img->d, img->w, img->h, img->c);
	} break;
	case MLIS_OPT_IMAGE_MASK: {
		const MLIS_Image *img = va_arg(ap, const MLIS_Image*);
		r = shim_call_i(S, "set_image_mask", "(KII)",
			(unsigned long long)(uintptr_t)img->d, img->w, img->h);
	} break;
	case MLIS_OPT_CONTROL_IMAGE: {
		const MLIS_Image *img = va_arg(ap, const MLIS_Image*);
		r = shim_call_i(S, "set_control_image", "(KIII)",
			(unsigned long long)(uintptr_t)img->d, img->w, img->h, img->c);
	} break;
	case MLIS_OPT_CALLBACK: {
		MLIS_Callback fn = va_arg(ap, MLIS_Callback);
		void *user = va_arg(ap, void*);
		r = shim_call_i(S, "set_callback", "(KK)",
			(unsigned long long)(uintptr_t)fn,
			(unsigned long long)(uintptr_t)user);
	} break;
	case MLIS_OPT_ERROR_HANDLER: {
		/* errors surface via return codes; the handler pointer is accepted
		 * for compatibility */
		(void)va_arg(ap, MLIS_ErrorHandler);
		(void)va_arg(ap, void*);
		r = 1;
	} break;
	default:
		break;
	}
end:
	va_end(ap);
	return r;
}

/* ---- pipeline ----------------------------------------------------------- */

int mlis_setup(MLIS_Ctx *S)    { return shim_call_i(S, "setup", ""); }
int mlis_generate(MLIS_Ctx *S) { return shim_call_i(S, "generate", ""); }

static const char* tensor_slot_name(MLIS_TensorId id)
{
	switch (id) {
	case MLIS_TENSOR_IMAGE:  return "image";
	case MLIS_TENSOR_MASK:   return "mask";
	case MLIS_TENSOR_LATENT: return "latent";
	case MLIS_TENSOR_LMASK:  return "lmask";
	case MLIS_TENSOR_COND:   return "cond";
	case MLIS_TENSOR_LABEL:  return "label";
	case MLIS_TENSOR_NCOND:  return "ncond";
	case MLIS_TENSOR_NLABEL: return "nlabel";
	default:
		if (id >= MLIS_TENSOR_TMP && id < MLIS_TENSOR_TMP + 4) {
			static const char *tmp[] = {"tmp0", "tmp1", "tmp2", "tmp3"};
			return tmp[id - MLIS_TENSOR_TMP];
		}
		return NULL;
	}
}

MLIS_Tensor* mlis_tensor_get(MLIS_Ctx *S, MLIS_TensorId id)
{
	const char *name = tensor_slot_name(id);
	if (!name) return NULL;
	int slot = (id >= MLIS_TENSOR_TMP) ? 8 + (id - MLIS_TENSOR_TMP)
	                                   : (int)id - 1;
	PyObject *res = shim_call(S, "tensor_get", "(s)", name);
	MLIS_Tensor *t = &S->tensors[slot];
	if (res) {
		unsigned long long ptr = 0;
		int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
		PyArg_ParseTuple(res, "Kiiii", &ptr, &n0, &n1, &n2, &n3);
		Py_DECREF(res);
		t->d = (float*)(uintptr_t)ptr;
		t->n[0] = n0; t->n[1] = n1; t->n[2] = n2; t->n[3] = n3;
	}
	return t;
}

MLIS_Image* mlis_image_get(MLIS_Ctx *S, int idx)
{
	PyObject *res = shim_call(S, "image_get", "(i)", idx);
	if (!res) return NULL;
	unsigned long long ptr = 0;
	unsigned w = 0, h = 0, c = 0;
	PyArg_ParseTuple(res, "KIII", &ptr, &w, &h, &c);
	Py_DECREF(res);
	if (!ptr) return NULL;
	S->imgex.d = (uint8_t*)(uintptr_t)ptr;
	S->imgex.w = w; S->imgex.h = h; S->imgex.c = c;
	S->imgex.sz = (size_t)w * h * c;
	return &S->imgex;
}

const char* mlis_infotext_get(MLIS_Ctx *S, int idx)
{
	(void)idx;
	PyObject *res = shim_call(S, "infotext_get", "");
	if (!res) return NULL;
	snprintf(S->infotext, sizeof(S->infotext), "%s", PyUnicode_AsUTF8(res));
	Py_DECREF(res);
	return S->infotext;
}

int mlis_text_tokenize(MLIS_Ctx *S, const char *text, int32_t **ptokens,
	MLIS_SubModel submodel)
{
	(void)submodel;
	PyObject *res = shim_call(S, "tokenize", "(s)", text);
	if (!res) return MLIS_E_UNKNOWN;
	unsigned long long ptr = 0;
	int count = 0;
	PyArg_ParseTuple(res, "Ki", &ptr, &count);
	Py_DECREF(res);
	if (count < 0) return count;
	if (ptokens) *ptokens = (int32_t*)(uintptr_t)ptr;
	return count;
}

int mlis_clip_text_encode(MLIS_Ctx *S, const char *text, MLIS_Tensor *embed,
	MLIS_Tensor *feat, MLIS_SubModel submodel, int flags)
{
	const char *sub = (submodel == MLIS_SUBMODEL_CLIP2) ? "clip2" : "clip";
	int r = shim_call_i(S, "clip_text_encode", "(sisi)", text,
		feat ? 1 : 0, sub, flags);
	if (r < 0) return r;
	if (embed) *embed = *mlis_tensor_get(S, MLIS_TENSOR_TMP);
	if (feat)  *feat  = *mlis_tensor_get(S, MLIS_TENSOR_TMP + 1);
	return r;
}

int mlis_image_encode(MLIS_Ctx *S, const MLIS_Tensor *image,
	MLIS_Tensor *latent, int flags)
{
	(void)flags;
	/* stage the input tensor, run, read back the latent slot */
	shim_call_i(S, "tensor_set", "(sKiiii)", "tmp2",
		(unsigned long long)(uintptr_t)image->d,
		image->n[0], image->n[1], image->n[2], image->n[3]);
	int r = shim_call_i(S, "image_encode", "(ss)", "tmp2", "latent");
	if (r >= 0 && latent)
		*latent = *mlis_tensor_get(S, MLIS_TENSOR_LATENT);
	return r;
}

int mlis_image_decode(MLIS_Ctx *S, const MLIS_Tensor *latent,
	MLIS_Tensor *image, int flags)
{
	(void)flags;
	shim_call_i(S, "tensor_set", "(sKiiii)", "tmp2",
		(unsigned long long)(uintptr_t)latent->d,
		latent->n[0], latent->n[1], latent->n[2], latent->n[3]);
	int r = shim_call_i(S, "image_decode", "(ss)", "tmp2", "image");
	if (r >= 0 && image)
		*image = *mlis_tensor_get(S, MLIS_TENSOR_IMAGE);
	return r;
}

int mlis_mask_encode(MLIS_Ctx *S, const MLIS_Tensor *mask,
	MLIS_Tensor *lmask, int flags)
{
	(void)S; (void)flags;
	/* block-mean downsize by 8 on the host, no python needed */
	int f = 8;
	int w = mask->n[0], h = mask->n[1];
	if (w % f || h % f || !lmask) return MLIS_E_IMAGE;
	int lw = w / f, lh = h / f;
	mlis_tensor_resize(lmask, lw, lh, 1, 1);
	for (int y = 0; y < lh; ++y)
	for (int x = 0; x < lw; ++x) {
		float acc = 0;
		for (int dy = 0; dy < f; ++dy)
		for (int dx = 0; dx < f; ++dx)
			acc += mask->d[(y * f + dy) * w + x * f + dx];
		lmask->d[y * lw + x] = acc / (f * f);
	}
	return 1;
}

const MLIS_BackendInfo* mlis_backend_info_get(MLIS_Ctx *S, unsigned idx,
	int flags)
{
	(void)flags;
	if (idx > 0) return NULL;   /* one backend: the active JAX platform */
	PyObject *res = shim_call(S, "backend_info", "");
	if (!res) return NULL;
	/* parse the JSON with minimal effort: stash strings, count devices */
	const char *js = PyUnicode_AsUTF8(res);
	snprintf(S->backend_strs, sizeof(S->backend_strs), "%s", js);
	Py_DECREF(res);
	S->backend_info.name = S->backend_strs;  /* raw JSON as the name field */
	S->backend_info.n_dev = 0;
	S->backend_info.devs = S->backend_devs;
	return &S->backend_info;
}

/* ---- tensor utilities (host-only, no python) ---------------------------- */

size_t mlis_tensor_count(const MLIS_Tensor *t)
{
	return (size_t)t->n[0] * t->n[1] * t->n[2] * t->n[3];
}

void mlis_tensor_resize(MLIS_Tensor *t, int n0, int n1, int n2, int n3)
{
	size_t n = (size_t)n0 * n1 * n2 * n3;
	t->n[0] = n0; t->n[1] = n1; t->n[2] = n2; t->n[3] = n3;
	t->d = realloc(t->flags & 1 ? t->d : NULL, n * sizeof(float));
	t->flags |= 1;  /* owns memory */
}

void mlis_tensor_resize_like(MLIS_Tensor *t, const MLIS_Tensor *src)
{
	mlis_tensor_resize(t, src->n[0], src->n[1], src->n[2], src->n[3]);
}

void mlis_tensor_copy(MLIS_Tensor *t, const MLIS_Tensor *src)
{
	mlis_tensor_resize_like(t, src);
	memcpy(t->d, src->d, mlis_tensor_count(src) * sizeof(float));
}

void mlis_tensor_free(MLIS_Tensor *t)
{
	if (t->flags & 1) free(t->d);
	memset(t, 0, sizeof(*t));
}

float mlis_tensor_similarity(const MLIS_Tensor *a, const MLIS_Tensor *b)
{
	size_t n = mlis_tensor_count(a);
	if (n != mlis_tensor_count(b) || !n) return 0.0f / 0.0f;
	double aa = 0, bb = 0, ab = 0;
	for (size_t i = 0; i < n; ++i) {
		aa += (double)a->d[i] * a->d[i];
		bb += (double)b->d[i] * b->d[i];
		ab += (double)a->d[i] * b->d[i];
	}
	double den = sqrt(aa * bb);
	return den > 0 ? (float)(ab / den) : 0.0f / 0.0f;
}

/* ---- enum strings ------------------------------------------------------- */

/* Name tables mirror the reference's canonical spellings
 * (reference: src/mlimgsynth.c:215-293) so round-tripping through
 * option_set_str / infotext matches byte-for-byte. */
static const char *g_stage_names[] = {
	"idle", "cond_encode", "image_encode", "image_decode", "denoise"};
static const char *g_stage_descs[] = {
	"Idle", "Conditioning encoding", "Image encoding", "Image decoding",
	"Denoising"};
static const char *g_method_names[] = {
	"none", "euler", "heun", "taylor3", "dpmpp2m", "dpmpp2s",
	"dpmpp2m_sde", "lcm", "unipc"};
static const char *g_sched_names[] = {"none", "uniform", "karras",
	"lcm", "exponential", "sgm_uniform", "beta"};
static const char *g_model_type_names[] = {"none", "sd1", "sd2", "sdxl",
	"sdxl_refiner", "sd3", "sd35_large", "sd35_medium", "flux_schnell",
	"flux_dev"};
static const char *g_model_type_descs[] = {
	"None", "Stable Diffusion 1.x", "Stable Diffusion 2.x",
	"Stable Diffusion XL", "Stable Diffusion XL refiner",
	"Stable Diffusion 3 (MMDiT)", "Stable Diffusion 3.5 Large",
	"Stable Diffusion 3.5 Medium (MMDiT-X)", "Flux.1 schnell",
	"Flux.1 dev"};
static const char *g_option_names[] = {
	"none", "backend", "model", "tae", "lora_dir", "lora", "lora_clear",
	"prompt", "nprompt", "image_dim", "batch_size", "clip_skip", "cfg_scale",
	"method", "scheduler", "steps", "f_t_ini", "f_t_end", "s_noise",
	"s_ancestral", "image", "image_mask", "no_decode", "tensor_use_flags",
	"seed", "vae_tile", "unet_split", "threads", "dump_flags", "aux_dir",
	"callback", "error_handler", "log_level", "model_type", "weight_type",
	"no_prompt_parse", "control_net", "control_image", "control_strength",
	"embed_dir", "hires_fix", "hires_denoise", "hires_steps",
	"refiner", "refiner_switch", "t5", "t5_tokenizer", "t5_tokens",
	"clip", "vae",
	"cfg_rescale", "slg_scale", "slg_layers", "slg_start", "slg_end",
	"pag_scale", "pag_start", "pag_end", "freeu", "deepcache",
	"subseed", "subseed_strength"};
static const struct { const char *name; int id; } g_loglvl_attr[] = {
	{ "none",    MLIS_LOGLVL_NONE },
	{ "error",   MLIS_LOGLVL_ERROR },
	{ "warning", MLIS_LOGLVL_WARNING },
	{ "info",    MLIS_LOGLVL_INFO },
	{ "verbose", MLIS_LOGLVL_VERBOSE },
	{ "debug",   MLIS_LOGLVL_DEBUG },
	{ "max",     MLIS_LOGLVL_MAX },
};

/* Case-insensitive id compare treating '-' as '_' and '+' as 'p' (so
 * "DPM++2M" parses as dpmpp2m), matching the reference's documented
 * option-name semantics. */
static int str_id_eq(const char *s, const char *name)
{
	for (;; ++s, ++name) {
		int c = (unsigned char)*s;
		if ('A' <= c && c <= 'Z') c += 'a' - 'A';
		else if (c == '-') c = '_';
		else if (c == '+') c = 'p';
		if (c != (unsigned char)*name) return 0;
		if (!c) return 1;
	}
}

#define ENUM_STR(fn, arr, T) \
const char* fn(T x) { \
	if ((int)x < 0 || (size_t)x >= sizeof(arr)/sizeof(arr[0])) return "???"; \
	return arr[x]; \
}
#define ENUM_FROMZ(fn, arr, T) \
T fn(const char *s) { \
	for (size_t i = 0; i < sizeof(arr)/sizeof(arr[0]); ++i) \
		if (str_id_eq(s, arr[i])) return (T)i; \
	return (T)-1; \
}

ENUM_STR(mlis_stage_str, g_stage_names, MLIS_Stage)
ENUM_STR(mlis_stage_desc, g_stage_descs, MLIS_Stage)
ENUM_STR(mlis_method_str, g_method_names, MLIS_Method)
ENUM_STR(mlis_sched_str, g_sched_names, MLIS_Scheduler)
ENUM_STR(mlis_model_type_str, g_model_type_names, MLIS_ModelType)
ENUM_STR(mlis_model_type_desc, g_model_type_descs, MLIS_ModelType)
ENUM_STR(mlis_option_str, g_option_names, MLIS_Option)
ENUM_FROMZ(mlis_stage_fromz, g_stage_names, MLIS_Stage)
ENUM_FROMZ(mlis_method_fromz, g_method_names, MLIS_Method)
ENUM_FROMZ(mlis_sched_fromz, g_sched_names, MLIS_Scheduler)
ENUM_FROMZ(mlis_model_type_fromz, g_model_type_names, MLIS_ModelType)
ENUM_FROMZ(mlis_option_fromz, g_option_names, MLIS_Option)

const char* mlis_loglvl_str(MLIS_LogLvl x)
{
	for (size_t i = 0; i < sizeof(g_loglvl_attr)/sizeof(g_loglvl_attr[0]); ++i)
		if ((int)x == g_loglvl_attr[i].id) return g_loglvl_attr[i].name;
	return "???";
}

MLIS_LogLvl mlis_loglvl_fromz(const char *s)
{
	for (size_t i = 0; i < sizeof(g_loglvl_attr)/sizeof(g_loglvl_attr[0]); ++i)
		if (str_id_eq(s, g_loglvl_attr[i].name))
			return (MLIS_LogLvl)g_loglvl_attr[i].id;
	return (MLIS_LogLvl)-1;
}

const char* mlis_state_str(MLIS_Stage x) { return mlis_stage_str(x); }
